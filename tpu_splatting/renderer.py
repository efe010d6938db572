"""Top-level 3D renderer composition.

Equivalent of taichi_splatting/renderer.py:23-118:
projection -> (optional SH shading) -> NDC depth -> tile mapping ->
rasterization -> (optional second non-blending pass for median depth).
Fully jit-compatible (static shapes; ``image_size`` and config are static).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from .data_types import Gaussians3D, RasterConfig
from .mapper.tile_mapper import map_to_tiles
from .perspective.params import CameraParams
from .perspective.projection import ndc_depth, project_to_image
from .rasterizer.function import detile, rasterize_tiled
from .rendering import RenderedPoints, Rendering
from .spherical_harmonics import evaluate_sh_at


def render_gaussians(
    gaussians: Gaussians3D,
    camera_params: CameraParams,
    config: RasterConfig = RasterConfig(),
    use_sh: bool = False,
    render_depth: bool = False,
    use_depth16: bool = False,
    render_median_depth: bool = False,
    max_overlaps: Optional[int] = None,
    heuristic_probe: Optional[jnp.ndarray] = None,
    tiled: bool = False,
) -> Rendering:
  """Complete 3D gaussian renderer (reference renderer.py:23-59).

  Args mirror the reference; ``max_overlaps`` sets the static overlap
  capacity and ``heuristic_probe`` is the zero-valued (N, 2) array whose
  gradient carries (prune_cost, split_score).  ``tiled`` keeps the
  Rendering's image fields in tile layout — training losses then never pay
  the detile/entile transposes (see Rendering docstring).
  """
  with jax.named_scope("project"):
    gaussians2d, depths, in_view = project_to_image(
        gaussians, camera_params, config)

  if use_sh:
    with jax.named_scope("sh"):
      features = evaluate_sh_at(
          gaussians.feature, jax.lax.stop_gradient(gaussians.position),
          camera_params.camera_position)
  else:
    features = gaussians.feature
    assert features.ndim == 2, (
        f"Features must be (N, C) if use_sh=False, got {features.shape}")

  return render_projected(
      in_view, gaussians2d, features, depths, camera_params, config,
      use_depth16=use_depth16, render_median_depth=render_median_depth,
      render_depth=render_depth, max_overlaps=max_overlaps,
      heuristic_probe=heuristic_probe, tiled=tiled)


def render_projected(
    in_view: jnp.ndarray,
    gaussians2d: jnp.ndarray,
    features: jnp.ndarray,
    depths: jnp.ndarray,
    camera_params: CameraParams,
    config: RasterConfig,
    use_depth16: bool = False,
    render_median_depth: bool = False,
    render_depth: bool = False,
    max_overlaps: Optional[int] = None,
    heuristic_probe: Optional[jnp.ndarray] = None,
    tiled: bool = False,
) -> Rendering:
  """Rasterize already-projected gaussians (reference renderer.py:62-108)."""
  image_size = camera_params.image_size
  ndc_depths = ndc_depth(depths, camera_params.near_plane,
                         camera_params.far_plane)
  # culled points have depth 0 sentinel -> keep the mapper's invalid mask
  ndc_depths = jnp.where(depths > 0, ndc_depths, 0.0)

  if render_depth:
    # composite (feature, depth, depth^2) in one pass -> expectation depth
    feats_all = jnp.concatenate([features, depths, depths ** 2], -1)
  else:
    feats_all = features
  f = features.shape[1]
  f_all = feats_all.shape[1]
  sg = jax.lax.stop_gradient

  mapping = map_to_tiles(
      sg(gaussians2d), sg(ndc_depths),
      image_size=image_size, config=config,
      max_overlaps=max_overlaps, use_depth16=use_depth16,
      features=sg(feats_all))
  tw, th = mapping.tiles_wide, mapping.tiles_high

  def layout(image_tiled):
    """(T, C, PIX) tile layout when ``tiled``, else (H, W, C)."""
    if tiled:
      return image_tiled
    return detile(image_tiled, tw, th, config.tile_size, image_size)

  def channel(x, c):
    return x[:, c, :] if tiled else x[..., c]

  image_tiled, visibility = rasterize_tiled(
      gaussians2d, feats_all, mapping, config, heuristic_probe)
  out = layout(image_tiled)
  image = channel(out, slice(0, f))
  image_weight = channel(out, f_all)
  depth_image = None
  if render_depth:
    depth_image = channel(out, f) / jnp.maximum(image_weight, 1e-10)

  median_depth = None
  if render_median_depth:
    median_cfg = dataclasses.replace(
        config, use_alpha_blending=False,
        saturate_threshold=config.median_threshold)
    med_tiled, _ = rasterize_tiled(sg(gaussians2d), sg(depths), mapping,
                                   median_cfg)
    median_depth = channel(layout(med_tiled), 0)

  points = RenderedPoints(
      in_view=in_view,
      depths=depths,
      gaussians2d=gaussians2d,
      features=features,
      _visibility=visibility,
      _prune_cost=None,
      _split_score=None,
  )

  return Rendering(
      image=image,
      image_weight=image_weight,
      depth_image=depth_image,
      median_depth_image=median_depth,
      points=points,
      camera=camera_params,
      config=config,
      num_overflow=mapping.num_overflow,
      tiled=tiled,
  )


def render_with_heuristics(
    loss_fn,
    gaussians: Gaussians3D,
    camera_params: CameraParams,
    config: RasterConfig = RasterConfig(),
    **render_kwargs,
):
  """Render, evaluate ``loss_fn(rendering)``, and run the backward pass,
  returning ``(loss, rendering, grads)`` with per-point heuristics populated.

  Parity with the reference, where the backward kernel fills
  ``point_heuristic`` on the forward output in place
  (taichi_splatting/rendering.py:41-54, rasterizer/backward.py:190-194) —
  impossible under jit, so the probe cotangent threading happens here
  instead of in every trainer: ``rendering.points.prune_cost`` /
  ``split_score`` are the gradients of a zero-valued probe input computed in
  the same backward pass as ``grads``.

  Args:
    loss_fn: Rendering -> scalar loss (may close over targets/regularizers).
    gaussians / camera_params / config: as for ``render_gaussians``.
    **render_kwargs: forwarded to ``render_gaussians``.

  Returns:
    (loss, rendering, grads): grads is a Gaussians3D cotangent pytree.
  """
  assert config.compute_point_heuristic, (
      "render_with_heuristics requires config.compute_point_heuristic")
  n = gaussians.position.shape[0]
  probe = jnp.zeros((n, 2), gaussians.position.dtype)

  def wrapped(g, probe):
    rendering = render_gaussians(g, camera_params, config,
                                 heuristic_probe=probe, **render_kwargs)
    return loss_fn(rendering), rendering

  (loss, rendering), (grads, gpr) = jax.value_and_grad(
      wrapped, argnums=(0, 1), has_aux=True)(gaussians, probe)
  points = rendering.points.replace(
      _prune_cost=gpr[:, 0], _split_score=gpr[:, 1])
  return loss, rendering.replace(points=points), grads


def viewspace_gradient(grad_gaussians2d: jnp.ndarray) -> jnp.ndarray:
  """Norm of the xy gradient (densify heuristic, renderer.py:113-118).

  Takes the gradient array directly (JAX has no .grad attribute): pass
  ``jax.grad(loss)(gaussians2d)``.
  """
  assert grad_gaussians2d.shape[1] == 7
  return jnp.linalg.norm(grad_gaussians2d[:, :2], axis=1)
