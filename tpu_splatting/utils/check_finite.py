"""Recursive non-finite guard (debug aid).

Equivalent of the reference check_finite
(taichi_splatting/torch_lib/util.py:7-51): counts/raises on
non-finite values across pytrees.  Host-side (forces a device sync) — use
between jitted steps, as the reference trainer does
(examples/fit_image_gaussians.py:124).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def count_nonfinite(tree) -> dict:
  """{path: count} of non-finite values for every floating leaf."""
  out = {}
  for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
    if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
      bad = int(np.sum(~np.isfinite(np.asarray(leaf))))
      if bad:
        out[jax.tree_util.keystr(path)] = bad
  return out


def check_finite(tree, name: str = "tree"):
  """Raise ValueError if any floating leaf contains non-finite values."""
  bad = count_nonfinite(tree)
  if bad:
    detail = ", ".join(f"{k}: {v}" for k, v in bad.items())
    raise ValueError(f"non-finite values in {name}: {detail}")
