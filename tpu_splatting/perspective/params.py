"""Camera parameters (pytree dataclass).

Equivalent of the reference CameraParams
(taichi_splatting/perspective/params.py:9-105).  The tensors
(projection, pose) are pytree leaves so gradients flow to camera intrinsics
and pose exactly as in the reference (projection.py:186-188); image size and
clip planes are static metadata.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


@dataclass
class CameraParams:
  projection: jnp.ndarray        # (4,) [fx, fy, cx, cy]
  T_camera_world: jnp.ndarray    # (4, 4) world -> camera

  near_plane: float
  far_plane: float
  image_size: Tuple[int, int]    # (width, height), static

  id: Optional[int] = None

  def __post_init__(self):
    assert len(self.image_size) == 2
    assert self.near_plane > 0
    assert self.far_plane > self.near_plane

  @property
  def depth_range(self):
    return (self.near_plane, self.far_plane)

  @property
  def focal_length(self):
    return self.projection[0:2]

  @property
  def principal_point(self):
    return self.projection[2:4]

  @property
  def T_image_camera(self) -> jnp.ndarray:
    fx, fy, cx, cy = (self.projection[0], self.projection[1],
                      self.projection[2], self.projection[3])
    z = jnp.zeros_like(fx)
    o = jnp.ones_like(fx)
    return jnp.stack([
        jnp.stack([fx, z, cx]),
        jnp.stack([z, fy, cy]),
        jnp.stack([z, z, o]),
    ])

  @property
  def T_image_world(self) -> jnp.ndarray:
    k44 = jnp.eye(4, dtype=self.T_camera_world.dtype).at[:3, :3].set(
        self.T_image_camera)
    return jnp.matmul(k44, self.T_camera_world, precision=_HIGHEST)

  @property
  def camera_position(self) -> jnp.ndarray:
    r = self.T_camera_world[:3, :3]
    t = self.T_camera_world[:3, 3]
    return -jnp.matmul(r.T, t, precision=_HIGHEST)

  def transformed(self, t: jnp.ndarray) -> "CameraParams":
    return dataclasses.replace(
        self, T_camera_world=jnp.matmul(t, self.T_camera_world,
                                        precision=_HIGHEST))

  def scale_image(self, scale: float) -> "CameraParams":
    image_size = (int(self.image_size[0] * scale),
                  int(self.image_size[1] * scale))
    return dataclasses.replace(
        self, image_size=image_size, projection=self.projection * scale)

  def replace(self, **kw) -> "CameraParams":
    return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    CameraParams,
    data_fields=["projection", "T_camera_world"],
    meta_fields=["near_plane", "far_plane", "image_size", "id"])
