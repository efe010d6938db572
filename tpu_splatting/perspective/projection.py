"""Perspective EWA projection of 3D gaussians to image space (pure jnp).

Re-design of the reference projection op
(taichi_splatting/perspective/projection.py:32-119 and
taichi_lib/generic.py:96-158).  Differences from the reference, by design:

* **No compaction / host sync.** The reference compacts visible points with
  ``torch.nonzero`` (projection.py:147-149), a GPU->CPU sync that cannot
  exist under jit.  We keep all N points and return an ``in_view`` boolean
  mask; culled points get zeroed outputs (depth = 0 sentinel, matching
  projection.py:70-71) and therefore zero gradients — the same effective
  semantics as the reference's index compaction.

* **No hand-written backward.** The reference differentiates this kernel with
  Taichi autodiff (projection.py:177).  Here the op is pure jnp; XLA fuses the
  pointwise chain and ``jax.grad`` provides gradients for the gaussian
  parameters AND camera pose/intrinsics (parity with projection.py:186-188).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..data_types import Gaussians3D, RasterConfig
from ..lib import gaussian2d as g2d
from ..lib import transforms
from .params import CameraParams

_HIGHEST = jax.lax.Precision.HIGHEST


def project_gaussians(
    position: jnp.ndarray,      # (N, 3)
    log_scaling: jnp.ndarray,   # (N, 3)
    rotation: jnp.ndarray,      # (N, 4) xyzw
    alpha_logit: jnp.ndarray,   # (N, 1)
    T_camera_world: jnp.ndarray,  # (4, 4) or (3, 4)
    projection: jnp.ndarray,    # (4,) fx fy cx cy
    image_size: Tuple[int, int],
    depth_range: Tuple[float, float],
    blur_cov: float = 0.3,
    clamp_margin: float = 0.15,
    alpha_threshold: float = 1.0 / 255.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
  """Project all gaussians; returns (points (N,7), depth (N,1), in_view (N,)).

  Mirrors the reference project_kernel (projection.py:51-81) with masking in
  place of compaction.
  """
  dtype = position.dtype
  f = projection[0:2]
  c = projection[2:4]
  r_cw = T_camera_world[:3, :3]
  t_cw = T_camera_world[:3, 3]
  image_size_f = jnp.asarray(image_size, dtype=dtype)

  # geometry in full f32: a TF32 product (the GPU default for f32 dots)
  # moves splats by pixels at scene depths
  in_camera = jnp.matmul(position, r_cw.T, precision=_HIGHEST) + t_cw
  z = in_camera[:, 2]

  near, far = depth_range
  valid_z = z > near
  z_safe = jnp.where(valid_z, z, jnp.ones_like(z))

  uv = f * in_camera[:, 0:2] / z_safe[:, None] + c

  # clamped projection point for the Jacobian (generic.py:114)
  t_clamped = jnp.clip(uv, -image_size_f * clamp_margin,
                       (image_size_f - 1.0) * (1.0 + clamp_margin))

  # EWA: m = J @ W @ R(q) S; cov2d = m m^T  (generic.py:116-143)
  rot_n = transforms.normalize(rotation)
  rs = transforms.scaled_quat_to_mat(rot_n, jnp.exp(log_scaling))  # (N,3,3)
  a = jnp.einsum("ij,njk->nik", r_cw, rs, precision=_HIGHEST)     # W @ RS

  fx_z = f[0] / z_safe
  fy_z = f[1] / z_safe
  gx_z = (t_clamped[:, 0] - c[0]) / z_safe
  gy_z = (t_clamped[:, 1] - c[1]) / z_safe

  m0 = fx_z[:, None] * a[:, 0, :] - gx_z[:, None] * a[:, 2, :]   # (N,3)
  m1 = fy_z[:, None] * a[:, 1, :] - gy_z[:, None] * a[:, 2, :]   # (N,3)

  cov = jnp.stack([
      (m0 * m0).sum(-1) + blur_cov,
      (m0 * m1).sum(-1),
      (m1 * m1).sum(-1) + blur_cov,
  ], -1)

  sigma, v1, v2 = g2d.eig2x2(cov)

  alpha = transforms.sigmoid(alpha_logit[:, 0])
  gscale = g2d.gaussian_scale(alpha, alpha_threshold)

  lower, upper = g2d.ellipse_bounds(
      uv, v1 * (sigma[:, 0] * gscale)[:, None],
      v2 * (sigma[:, 1] * gscale)[:, None])

  in_view = (valid_z & (z < far) & (gscale > 0)
             & jnp.all(upper > 0, -1) & jnp.all(lower < image_size_f, -1))

  points = g2d.pack_g2d(uv, v1, sigma, alpha)
  points = jnp.where(in_view[:, None], points, jnp.zeros_like(points))
  depth = jnp.where(in_view, z, jnp.zeros_like(z))[:, None]
  return points, depth, in_view


def project_to_image(
    gaussians: Gaussians3D, camera_params: CameraParams, config: RasterConfig
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
  """Project 3D gaussians to packed 2D gaussians (EWA splatting).

  API parity with the reference (projection.py:220-251) except the third
  return is an ``in_view`` boolean mask rather than compacted indexes.
  """
  return project_gaussians(
      *gaussians.shape_tensors(),
      camera_params.T_camera_world,
      camera_params.projection,
      camera_params.image_size,
      camera_params.depth_range,
      blur_cov=config.blur_cov,
      clamp_margin=config.clamp_margin,
      alpha_threshold=config.alpha_threshold,
  )


def ndc_depth(depth: jnp.ndarray, near: float, far: float) -> jnp.ndarray:
  """Depth -> [0, 1] NDC (reference torch_lib/projection.py:120-124)."""
  return 1.0 - (1.0 / depth - 1.0 / far) / (1.0 / near - 1.0 / far)


def inverse_ndc_depth(ndc: jnp.ndarray, near: float, far: float) -> jnp.ndarray:
  """NDC [0, 1] -> depth (reference torch_lib/projection.py:127-130)."""
  return 1.0 / ((1.0 - ndc) * (1.0 / near - 1.0 / far) + 1.0 / far)


def unproject_points(uv: jnp.ndarray, depth: jnp.ndarray,
                     T_image_world: jnp.ndarray) -> jnp.ndarray:
  """Image uv + depth -> world points (torch_lib/projection.py:56-60)."""
  t_world_image = jnp.linalg.inv(T_image_world)
  depth = depth if depth.ndim == uv.ndim else depth[..., None]
  homog = jnp.concatenate([uv * depth, depth, jnp.ones_like(depth)], -1)
  world = jnp.matmul(homog, t_world_image.T, precision=_HIGHEST)
  return world[..., :3] / world[..., 3:4]
