"""Random scene fixtures (numpy/jnp port of the reference fixtures).

Behaviour mirrors taichi_splatting/tests/random_data.py:
random in-frustum cameras, 3D gaussians unprojected from random image UVs
with NDC-uniform depth, and random 2D gaussians.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from tpu_splatting import CameraParams, Gaussians2D, Gaussians3D
from tpu_splatting.lib import transforms
from tpu_splatting.perspective import inverse_ndc_depth, unproject_points


def _normalize(v, axis=-1):
  return v / np.linalg.norm(v, axis=axis, keepdims=True)


def random_camera(rng: np.random.Generator, pos_scale: float = 1.0,
                  image_size: Optional[Tuple[int, int]] = None,
                  image_size_range=(256, 1024), near_plane=0.1,
                  dtype=jnp.float32) -> CameraParams:
  q = _normalize(rng.standard_normal(4))
  t = rng.standard_normal(3) * pos_scale

  r = np.asarray(transforms.quat_to_mat(jnp.asarray(q)))
  t_world_camera = np.asarray(transforms.join_rt(jnp.asarray(r), jnp.asarray(t)))
  t_camera_world = np.linalg.inv(t_world_camera)

  if image_size is None:
    image_size = tuple(int(x) for x in rng.integers(*image_size_range, size=2))

  w, h = image_size
  cx, cy = np.array([w / 2, h / 2]) + rng.standard_normal(2) * (w / 20)

  fov = np.deg2rad(rng.random() * 70 + 30)
  fx = w / (2 * np.tan(fov / 2))
  fy = h / (2 * np.tan(fov / 2))

  return CameraParams(
      T_camera_world=jnp.asarray(t_camera_world, dtype=dtype),
      projection=jnp.asarray([fx, fy, cx, cy], dtype=dtype),
      image_size=(w, h),
      near_plane=near_plane,
      far_plane=near_plane * 1000.0,
  )


def random_3d_gaussians(rng: np.random.Generator, n: int,
                        camera_params: CameraParams, scale_factor: float = 1.0,
                        alpha_range=(0.1, 0.9), margin: float = 0.0,
                        num_channels: int = 3,
                        dtype=jnp.float32) -> Gaussians3D:
  w, h = camera_params.image_size
  uv_pos = (rng.random((n, 2)) * (1 + margin) - margin * 0.5) * np.array([w, h])

  depth = np.asarray(inverse_ndc_depth(
      jnp.asarray(rng.random(n)), camera_params.near_plane * 2,
      camera_params.far_plane))

  position = unproject_points(
      jnp.asarray(uv_pos, dtype=jnp.float64),
      jnp.asarray(depth[:, None], dtype=jnp.float64),
      jnp.asarray(camera_params.T_image_world, dtype=jnp.float64))

  fx = float(camera_params.projection[0])
  scale = (w / math.sqrt(n)) * (depth / fx) * scale_factor
  log_scaling = rng.standard_normal((n, 3)) * 0.5 + np.log(scale)[:, None]

  rotation = _normalize(rng.standard_normal((n, 4)))

  low, high = alpha_range
  alpha = rng.random(n) * (high - low) + low
  alpha_logit = np.log(alpha / (1 - alpha))

  return Gaussians3D(
      position=jnp.asarray(position, dtype=dtype),
      log_scaling=jnp.asarray(log_scaling, dtype=dtype),
      rotation=jnp.asarray(rotation, dtype=dtype),
      alpha_logit=jnp.asarray(alpha_logit[:, None], dtype=dtype),
      feature=jnp.asarray(rng.random((n, num_channels)), dtype=dtype),
  )


def random_2d_gaussians(rng: np.random.Generator, n: int,
                        image_size: Tuple[int, int], num_channels: int = 3,
                        scale_factor: float = 1.0, alpha_range=(0.1, 0.9),
                        depth_range=(0.0, 1.0),
                        dtype=jnp.float32) -> Gaussians2D:
  w, h = image_size
  position = rng.random((n, 2)) * np.array([w, h])
  depth = (rng.random(n) * (depth_range[1] - depth_range[0]) + depth_range[0])

  density_scale = scale_factor * w / (1 + math.sqrt(n))
  scaling = (rng.random((n, 2)) + 0.2) * density_scale

  rotation = _normalize(rng.standard_normal((n, 2)))

  low, high = alpha_range
  alpha = rng.random(n) * (high - low) + low
  alpha_logit = np.log(alpha / (1 - alpha))

  return Gaussians2D(
      position=jnp.asarray(position, dtype=dtype),
      depths=jnp.asarray(depth, dtype=dtype),
      log_scaling=jnp.asarray(np.log(scaling), dtype=dtype),
      rotation=jnp.asarray(rotation, dtype=dtype),
      alpha_logit=jnp.asarray(alpha_logit[:, None], dtype=dtype),
      feature=jnp.asarray(rng.random((n, num_channels)), dtype=dtype),
  )
