"""Where the persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it, and
nothing else is configured.  Otherwise the cache is kept at the fixed path
``<checkout>/.jaxcache`` (the path is part of the cache key, so it must not
move between runs).
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
  """Point JAX's persistent compilation cache at its directory; returns it."""
  path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
  if path:
    return path
  path = os.path.join(CHECKOUT, ".jaxcache")
  jax.config.update("jax_compilation_cache_dir", path)
  jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
  return path
