"""Spherical-harmonics shading (pure jnp).

Equivalent of the reference SH evaluation kernels
(taichi_splatting/indexed_spherical_harmonics.py:118-177 and
spherical_harmonics.py:40-133).  The evaluation is a basis-polynomial
evaluation plus a per-point contraction — a fit for XLA fusion, so no
Pallas kernel is required; ``jax.grad`` replaces the
reference's Taichi-autodiff backward (indexed_spherical_harmonics.py:152-160),
giving gradients for the SH coefficients, positions AND camera position.

Divergence from the reference: no index gather — the pipeline keeps all N
points with an ``in_view`` mask (see perspective/projection.py), so the
"indexed" gather variant is unnecessary.  Pass ``indexes`` only if you want
gather-compatible behaviour.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .lib import transforms
from .lib.sh import check_sh_degree, rsh_cart


def evaluate_sh_at(
    sh_params: jnp.ndarray,     # (N, K, (d+1)^2) coefficients
    positions: jnp.ndarray,     # (N, 3)
    camera_pos: jnp.ndarray,    # (3,)
    indexes: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
  """Evaluate SH colour at each gaussian as seen from ``camera_pos``.

  Returns (N, K) features, offset by +0.5 and clamped to [0, 1]
  (indexed_spherical_harmonics.py:132-134).
  """
  degree = check_sh_degree(sh_params)

  if indexes is not None:
    sh_params = sh_params[indexes]
    positions = positions[indexes]

  direction = transforms.normalize(positions - camera_pos)
  basis = rsh_cart(direction, degree)              # (N, B)
  out = jnp.einsum("nkb,nb->nk", sh_params, basis,
                   precision=jax.lax.Precision.HIGHEST)
  return jnp.clip(out + 0.5, 0.0, 1.0)
