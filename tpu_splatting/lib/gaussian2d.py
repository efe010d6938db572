"""2D Gaussian (splat) math — packing, eigendecomposition, pdf evaluation.

Pure-jnp, batched re-implementation of the device-function
library in the reference (taichi_splatting/taichi_lib/
generic.py:30-58 packing, :217-237 eig/bounds, :258-304 conic helpers,
:306-404 axis/sigma pdf + anti-aliased pdf).

Packed Gaussian2D layout, identical field order to the reference
(generic.py:30-41):

  ``[mean_x, mean_y, axis_x, axis_y, sigma_x, sigma_y, alpha]``  (7 floats)

where ``axis`` is the unit-length major eigenvector of the image-space
covariance, ``sigma = (sqrt(lambda1), sqrt(lambda2))`` are the std-devs along
the major / minor axes and ``alpha`` is the post-sigmoid opacity.
"""

from __future__ import annotations

import jax.numpy as jnp

G2D_SIZE = 7  # packed width (generic.py:37 struct_size(Gaussian2D))


def pack_g2d(mean, axis, sigma, alpha) -> jnp.ndarray:
  """Pack components into the (..., 7) layout (generic.py:39-41)."""
  return jnp.concatenate([mean, axis, sigma, alpha[..., None]], -1)


def unpack_g2d(vec: jnp.ndarray):
  """(..., 7) -> (mean, axis, sigma, alpha) (generic.py:48-50)."""
  return vec[..., 0:2], vec[..., 2:4], vec[..., 4:6], vec[..., 6]


def perp(v: jnp.ndarray) -> jnp.ndarray:
  """90-degree rotation of a 2-vector (generic.py:306-308)."""
  return jnp.stack([-v[..., 1], v[..., 0]], -1)


def eig2x2(cov: jnp.ndarray, eps: float = 1e-12):
  """Closed-form eigendecomposition of a symmetric 2x2 matrix.

  ``cov`` holds the upper-triangular entries ``(a, b, c)`` stacked on the last
  axis.  Returns ``(sigma, v1, v2)`` where ``sigma = sqrt(eigenvalues)``
  (descending), ``v1`` the unit major axis and ``v2 = perp(v1)``.
  Mirrors generic.py:217-230 with f32-safe guards: near-isotropic
  covariances (ill-conditioned eigenvector, sqrt(gap) gradient -> inf when
  the gap rounds to 0 in f32) fall back to ``v1 = (1, 0)`` with zero
  direction gradient instead of producing NaN/Inf.
  """
  a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
  tr = a + c
  det = a * c - b * b

  gap = tr * tr - 4.0 * det
  # the lower clamp keeps d(sqrt)/d(gap) finite when gap underflows to 0
  sqrt_gap = jnp.sqrt(jnp.maximum(gap, 1e-18))

  lam1 = (tr + sqrt_gap) * 0.5
  lam2 = (tr - sqrt_gap) * 0.5

  vx, vy = a - lam2, b
  n2 = vx * vx + vy * vy
  safe = n2 > eps
  vx_s = jnp.where(safe, vx, 1.0)
  vy_s = jnp.where(safe, vy, 0.0)
  inv_n = 1.0 / jnp.sqrt(vx_s * vx_s + vy_s * vy_s)
  v1 = jnp.stack([vx_s * inv_n, vy_s * inv_n], -1)
  v2 = perp(v1)

  sigma = jnp.sqrt(jnp.maximum(jnp.stack([lam1, lam2], -1), 1e-20))
  return sigma, v1, v2


def ellipse_bounds(uv: jnp.ndarray, a1: jnp.ndarray, a2: jnp.ndarray):
  """Axis-aligned bounds of an ellipse given its two scaled axes.

  Mirrors generic.py:234-237: extent = sqrt(a1**2 + a2**2) elementwise.
  """
  extent = jnp.sqrt(a1 * a1 + a2 * a2)
  return uv - extent, uv + extent


def gaussian_scale(alpha: jnp.ndarray, alpha_threshold: float) -> jnp.ndarray:
  """Opacity-dependent cull radius in units of sigma.

  ``sqrt(2 ln(alpha / threshold))`` (grid_query.py:76, projection.py:62);
  clamped at zero so alpha <= threshold gives radius 0 instead of NaN.
  """
  return jnp.sqrt(jnp.maximum(2.0 * jnp.log(jnp.maximum(alpha, 1e-30) / alpha_threshold), 0.0))


def upper_tri(m: jnp.ndarray) -> jnp.ndarray:
  """(..., 2, 2) symmetric matrix -> (..., 3) upper entries (generic.py:266-267)."""
  return jnp.stack([m[..., 0, 0], m[..., 0, 1], m[..., 1, 1]], -1)


def inverse_cov(cov: jnp.ndarray) -> jnp.ndarray:
  """Inverse of a symmetric 2x2 in upper-tri form (generic.py:259-262)."""
  a, b, c = cov[..., 0], cov[..., 1], cov[..., 2]
  inv_det = 1.0 / (a * c - b * b)
  return jnp.stack([inv_det * c, -inv_det * b, inv_det * a], -1)


def cov_from_g2d(axis: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
  """Reconstruct upper-tri covariance from (axis, sigma) parameterisation."""
  v2 = perp(axis)
  s1, s2 = sigma[..., 0] ** 2, sigma[..., 1] ** 2
  a = s1 * axis[..., 0] ** 2 + s2 * v2[..., 0] ** 2
  b = s1 * axis[..., 0] * axis[..., 1] + s2 * v2[..., 0] * v2[..., 1]
  c = s1 * axis[..., 1] ** 2 + s2 * v2[..., 1] ** 2
  return jnp.stack([a, b, c], -1)


def conic_pdf(xy: jnp.ndarray, uv: jnp.ndarray, conic: jnp.ndarray) -> jnp.ndarray:
  """exp(-0.5 d^T C d) in conic form (generic.py:277-284)."""
  d = xy - uv
  a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
  dx, dy = d[..., 0], d[..., 1]
  inner = 0.5 * (dx * dx * a + dy * dy * c) + dx * dy * b
  return jnp.exp(-inner)


def gaussian_pdf(xy: jnp.ndarray, mean: jnp.ndarray, axis: jnp.ndarray,
                 sigma: jnp.ndarray) -> jnp.ndarray:
  """Un-normalised pdf in the axis/sigma parameterisation (generic.py:311-317)."""
  d = xy - mean
  tx = (d * axis).sum(-1) / sigma[..., 0]
  ty = (d * perp(axis)).sum(-1) / sigma[..., 1]
  return jnp.exp(-0.5 * (tx * tx + ty * ty))


def s_sig(x: jnp.ndarray, sigma) -> jnp.ndarray:
  """Logistic approximation of the Gaussian CDF (generic.py:340-344)."""
  z = x / sigma
  return 1.0 / (1.0 + jnp.exp(-1.6 * z - 0.07 * z ** 3))


def gaussian_pdf_antialias(xy: jnp.ndarray, mean: jnp.ndarray, axis: jnp.ndarray,
                           sigma: jnp.ndarray) -> jnp.ndarray:
  """Pixel-integrated (anti-aliased) pdf (generic.py:347-357)."""
  d = xy - mean
  sx, sy = sigma[..., 0], sigma[..., 1]
  tx = (d * axis).sum(-1)
  ty = (d * perp(axis)).sum(-1)

  ix = sx * (s_sig(tx + 0.5, sx) - s_sig(tx - 0.5, sx))
  iy = sy * (s_sig(ty + 0.5, sy) - s_sig(ty - 0.5, sy))
  return 2.0 * jnp.pi * ix * iy
