"""Rendering output types (pytree dataclasses).

Equivalents of the reference output TensorClasses
(taichi_splatting/rendering.py:27-157).  Divergence: the
pipeline is uncompacted (static shapes), so ``RenderedPoints`` covers all N
points with an ``in_view`` mask instead of a compacted index list; ``idx``
is retained for API parity as ``arange(N)`` masked semantics.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from .data_types import RasterConfig
from .perspective.params import CameraParams
from .perspective.projection import ndc_depth


@dataclass
class RenderedPoints:
  """Per-point outputs of a render (reference rendering.py:27-101)."""
  in_view: jnp.ndarray              # (N,) bool — mask replacing ref `idx`
  depths: jnp.ndarray               # (N, 1)
  gaussians2d: jnp.ndarray          # (N, 7)
  features: jnp.ndarray             # (N, F)

  _visibility: Optional[jnp.ndarray] = None    # (N,)
  _prune_cost: Optional[jnp.ndarray] = None    # (N,)
  _split_score: Optional[jnp.ndarray] = None   # (N,)

  @property
  def idx(self) -> jnp.ndarray:
    """Indices of in-view points' positions (parity helper; static shape —
    culled entries hold their own index too, filter with ``in_view``)."""
    return jnp.arange(self.in_view.shape[0])

  @property
  def visibility(self) -> jnp.ndarray:
    assert self._visibility is not None, (
        "No visibility available (render with config.compute_visibility)")
    return self._visibility

  @property
  def prune_cost(self) -> jnp.ndarray:
    assert self._prune_cost is not None, (
        "No prune cost available (render with config.compute_point_heuristic"
        " and take grads of the heuristic probe)")
    return self._prune_cost

  @property
  def split_score(self) -> jnp.ndarray:
    assert self._split_score is not None, (
        "No split score available (render with config.compute_point_heuristic"
        " and take grads of the heuristic probe)")
    return self._split_score

  @property
  def visible_mask(self) -> jnp.ndarray:
    return self.visibility > 0.0

  @property
  def screen_scale(self) -> jnp.ndarray:
    return self.gaussians2d[:, 4:6]

  @property
  def opacity(self) -> jnp.ndarray:
    return self.gaussians2d[:, 6]

  def gaussian_scale(self, alpha_threshold: float = 1.0 / 255.0):
    return jnp.sqrt(jnp.maximum(
        2.0 * jnp.log(jnp.maximum(self.opacity, 1e-30) / alpha_threshold),
        0.0))

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    RenderedPoints,
    data_fields=["in_view", "depths", "gaussians2d", "features",
                 "_visibility", "_prune_cost", "_split_score"],
    meta_fields=[])


@dataclass
class Rendering:
  """Full render output (reference rendering.py:105-157).

  When ``tiled`` (``render_projected(tiled=True)``) the image fields stay
  in TILE layout — image (T, C, PIX), image_weight / depth images
  (T, PIX) — so a training loss can run without the detile/entile
  transposes (pair with ``rasterizer.function.entile`` on the target and
  ``tile_mask`` for valid pixels; ``detile`` recovers (H, W, C)).
  """
  image: jnp.ndarray                          # (H, W, C) | (T, C, PIX)
  image_weight: jnp.ndarray                   # (H, W)    | (T, PIX)

  points: RenderedPoints
  camera: CameraParams
  config: RasterConfig

  depth_image: Optional[jnp.ndarray] = None           # (H, W)
  median_depth_image: Optional[jnp.ndarray] = None    # (H, W)
  # () i32 — overlap rows dropped by the mapper's static capacities.
  # A render is only exact when this is 0; trainers should assert it
  # (or raise max_overlaps / big_capacity) — capacity overflow is COUNTED,
  # never silent (divergence from the reference, which reallocates on the
  # host instead; see MIGRATION.md).
  num_overflow: Optional[jnp.ndarray] = None
  # Image fields are in tile layout (see class docstring).
  tiled: bool = False

  @property
  def ndc_image(self) -> jnp.ndarray:
    return ndc_depth(self.depth_image, self.camera.near_plane,
                     self.camera.far_plane)

  @property
  def median_ndc_image(self) -> jnp.ndarray:
    return ndc_depth(self.median_depth_image, self.camera.near_plane,
                     self.camera.far_plane)

  @property
  def in_view_mask(self) -> jnp.ndarray:
    return self.points.in_view

  @property
  def image_size(self):
    return self.camera.image_size

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    Rendering,
    data_fields=["image", "image_weight", "points", "camera",
                 "depth_image", "median_depth_image", "num_overflow"],
    meta_fields=["config", "tiled"])
