"""Core data types: RasterConfig and Gaussian pytrees.

Equivalents of the reference data model
(taichi_splatting/data_types.py:16-143):

* ``RasterConfig`` — frozen, hashable dataclass used as a *static* jit
  argument (the reference uses it as a Taichi kernel cache key,
  data_types.py:16-46; under XLA it becomes part of the compilation key).
  Extended with the tile mapper's static capacities, which replace the
  reference's host-synchronised dynamic allocation (SURVEY.md §2.1).

* ``Gaussians3D`` / ``Gaussians2D`` — registered dataclass pytrees with the
  same fields and activation conventions as the reference TensorClasses
  (data_types.py:57-143).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .lib import transforms


@dataclass(frozen=True, eq=True, kw_only=True)
class RasterConfig:
  """Rasterisation behaviour config (static under jit).

  Field semantics match the reference (data_types.py:16-46); the fields after
  ``median_threshold`` are the tile mapper's static capacities.
  """
  tile_size: int = 16

  # clamp position to within this margin of the image for the affine Jacobian
  clamp_margin: float = 0.15

  # use the anti-aliased (pixel-integrated) pdf
  antialias: bool = False

  # blur covariance: diagonal added to the projected covariance
  blur_cov: float = 0.3

  clamp_max_alpha: float = 0.99
  alpha_threshold: float = 1.0 / 255.0

  # stop alpha blending at this point.
  # Divergence: applied consistently in forward AND backward as a
  # transmittance "freeze" (the reference forward keeps accumulating past
  # saturation in blending mode while its backward stops — see
  # rasterizer/forward.py:101-112 vs backward.py:154; we freeze in both so the
  # custom_vjp is the exact gradient of the forward).
  saturate_threshold: float = 0.9999

  # if False, compute a quantile (e.g. median) instead of blending
  use_alpha_blending: bool = True

  compute_point_heuristic: bool = False  # implies compute_visibility
  compute_visibility: bool = False

  median_threshold: float = 0.25

  # --- static capacities of the tile mapper --------------------------------

  # Per-gaussian candidate tile window (tiles per axis) for the tile mapper's
  # small-gaussian path. Gaussians spanning more tiles go to the big path.
  # Candidates cost n * tile_window^2 sort rows, so keep this tight;
  # trained-scene splats rarely span more than 3 tiles.
  tile_window: int = 3

  # Capacity of the big-gaussian path (number of gaussians routed to the
  # wider window) and its window size.
  big_capacity: int = 8192
  big_tile_window: int = 16

  @property
  def tile_area(self) -> int:
    return self.tile_size * self.tile_size


# ---------------------------------------------------------------------------
# Gaussian pytrees
# ---------------------------------------------------------------------------


def _register(cls, data_fields):
  jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=[])
  return cls


@dataclass
class Gaussians3D:
  """3D Gaussian mixture (reference data_types.py:57-114).

  Fields (N leading batch dim):
    position:    (N, 3) xyz
    log_scaling: (N, 3) scale = exp(log_scaling)
    rotation:    (N, 4) quaternion, xyzw layout (scalar last)
    alpha_logit: (N, 1) alpha = sigmoid(alpha_logit)
    feature:     (N, C) or (N, 3, (d+1)**2) SH coefficients
  """
  position: jnp.ndarray
  log_scaling: jnp.ndarray
  rotation: jnp.ndarray
  alpha_logit: jnp.ndarray
  feature: jnp.ndarray

  def __len__(self):
    return self.position.shape[0]

  @property
  def batch_size(self):
    return (self.position.shape[0],)

  def packed(self) -> jnp.ndarray:
    """(N, 11) packed layout (reference data_types.py:72-73)."""
    return jnp.concatenate(
        [self.position, self.log_scaling, self.rotation, self.alpha_logit], -1)

  @staticmethod
  def from_packed(packed: jnp.ndarray, feature: jnp.ndarray) -> "Gaussians3D":
    return Gaussians3D(
        position=packed[:, 0:3], log_scaling=packed[:, 3:6],
        rotation=packed[:, 6:10], alpha_logit=packed[:, 10:11],
        feature=feature)

  def shape_tensors(self):
    return (self.position, self.log_scaling, self.rotation, self.alpha_logit)

  @property
  def scale(self):
    return jnp.exp(self.log_scaling)

  @property
  def alpha(self):
    return transforms.sigmoid(self.alpha_logit)

  def scaled(self, scale: float) -> "Gaussians3D":
    return dataclasses.replace(
        self, position=self.position * scale,
        log_scaling=self.log_scaling + math.log(scale))

  def translated(self, translation: jnp.ndarray) -> "Gaussians3D":
    return dataclasses.replace(
        self, position=self.position + translation.reshape(1, 3))

  def transform_rigid(self, m44: jnp.ndarray) -> "Gaussians3D":
    """Rigid transform of positions and orientations (data_types.py:91-102)."""
    position = transforms.transform_points(m44, self.position)
    r, _ = transforms.split_rt(m44)
    # rotate the quaternion by the matrix's quaternion: q' = q_m * q
    q_m = mat_to_quat(r)
    rotation = transforms.quat_mul(
        jnp.broadcast_to(q_m, self.rotation.shape), self.rotation)
    return dataclasses.replace(self, position=position, rotation=rotation)

  def replace(self, **kw) -> "Gaussians3D":
    return dataclasses.replace(self, **kw)

  @staticmethod
  def concat(gaussians) -> "Gaussians3D":
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *gaussians)


@dataclass
class Gaussians2D:
  """2D Gaussian mixture (reference data_types.py:122-143).

  Fields (N leading batch dim):
    position:    (N, 2) xy
    depths:      (N,) or (N, 1) depth for sorting
    log_scaling: (N, 2)
    rotation:    (N, 2) unit-length 2-vector (major axis direction)
    alpha_logit: (N, 1)
    feature:     (N, C)
  """
  position: jnp.ndarray
  depths: jnp.ndarray
  log_scaling: jnp.ndarray
  rotation: jnp.ndarray
  alpha_logit: jnp.ndarray
  feature: jnp.ndarray

  def __len__(self):
    return self.position.shape[0]

  @property
  def batch_size(self):
    return (self.position.shape[0],)

  @property
  def opacity(self):
    return transforms.sigmoid(self.alpha_logit)

  @property
  def scaling(self):
    return jnp.exp(self.log_scaling)

  def set_scaling(self, scaling) -> "Gaussians2D":
    return dataclasses.replace(self, log_scaling=jnp.log(scaling))

  def replace(self, **kw) -> "Gaussians2D":
    return dataclasses.replace(self, **kw)


_register(Gaussians3D,
          ["position", "log_scaling", "rotation", "alpha_logit", "feature"])
_register(Gaussians2D,
          ["position", "depths", "log_scaling", "rotation", "alpha_logit",
           "feature"])


def mat_to_quat(r: jnp.ndarray) -> jnp.ndarray:
  """Rotation matrix (3,3) -> quaternion xyzw (branch-free Shepperd)."""
  m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
  m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
  m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
  tr = m00 + m11 + m22

  def q_from(t, a, b, c, d):
    s = jnp.sqrt(jnp.maximum(t, 1e-12)) * 2.0
    return jnp.stack([a / s, b / s, c / s, d / s])

  # four candidate formulations; pick by largest pivot for stability
  qw = q_from(1.0 + tr, m21 - m12, m02 - m20, m10 - m01, 1.0 + tr)
  qx = q_from(1.0 + m00 - m11 - m22, 1.0 + m00 - m11 - m22, m01 + m10,
              m02 + m20, m21 - m12)
  qy = q_from(1.0 - m00 + m11 - m22, m01 + m10, 1.0 - m00 + m11 - m22,
              m12 + m21, m02 - m20)
  qz = q_from(1.0 - m00 - m11 + m22, m02 + m20, m12 + m21,
              1.0 - m00 - m11 + m22, m10 - m01)

  pivots = jnp.stack([tr, m00, m11, m22])
  idx = jnp.argmax(pivots)
  q = jnp.stack([qw, qx, qy, qz])[idx]
  return transforms.normalize(q)
