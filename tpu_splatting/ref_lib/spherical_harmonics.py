"""Direct per-point SH evaluation ground truth.

Mirror of the reference's torch SH layer
(taichi_splatting/torch_lib/spherical_harmonics.py:16-43
over generated rsh.py polynomials): normalize view directions, evaluate the
real SH basis, contract, offset by +0.5 and clamp — written with explicit
numpy-style steps, independent of the production einsum in
tpu_splatting/spherical_harmonics.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..lib.sh import check_sh_degree, rsh_cart


def reference_sh(params: jnp.ndarray, positions: jnp.ndarray,
                 camera_pos: jnp.ndarray) -> jnp.ndarray:
  """params (N, K, (d+1)^2), positions (N, 3), camera_pos (3,) -> (N, K)."""
  degree = check_sh_degree(params)
  d = positions - camera_pos
  d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
  basis = rsh_cart(d, degree)                       # (N, B)
  out = jnp.sum(params * basis[:, None, :], axis=-1)
  return jnp.clip(out + 0.5, 0.0, 1.0)
