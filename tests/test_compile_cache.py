"""The compile-cache helper honours JAX_COMPILATION_CACHE_DIR and otherwise
uses the fixed path <checkout>/.jaxcache."""

import os

import jax

from tpu_splatting.utils import compile_cache


def _restore(old):
  jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_from_environment(monkeypatch, tmp_path):
  old = jax.config.jax_compilation_cache_dir
  monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
  jax.config.update("jax_compilation_cache_dir", "unchanged")
  try:
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    # nothing is set in code when the environment names the directory
    assert jax.config.jax_compilation_cache_dir == "unchanged"
  finally:
    _restore(old)


def test_cache_dir_default_in_checkout(monkeypatch):
  old = jax.config.jax_compilation_cache_dir
  monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
  try:
    path = compile_cache.setup_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jaxcache")
    assert jax.config.jax_compilation_cache_dir == path
  finally:
    _restore(old)
