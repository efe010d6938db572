"""Differentiable rasterization API (custom_vjp around the raster kernels).

Equivalent of the reference autograd wrapper
(taichi_splatting/rasterizer/function.py:28-165).  Notable design
differences:

* **Rows come out of the sort.**  The tile mapper sorts the candidate
  domain with the point and feature rows riding the sort as payload, so the
  kernels read each tile's rows as one contiguous range; only a mapping
  built without features (or with another feature width, as the
  median-depth pass) gathers its rows here.

* **image_alpha is differentiable.**  The alpha image is composited as an
  extra channel inside the kernel (the reference marks it
  non-differentiable, function.py:73).

* **Point heuristics as probe gradients.**  The reference fills
  ``point_heuristic`` during backward by mutating a forward output
  (function.py:52-92) — impossible under jit.  Here ``rasterize`` accepts a
  zero-valued ``heuristic_probe`` input whose *cotangent* is defined to be
  the heuristics, so trainers obtain them with
  ``jax.grad(loss, argnums=probe)`` in the same backward pass (or use
  ``renderer.render_with_heuristics``).

* **Quantile (non-blending) mode is forward-only** — the reference's
  backward silently computes blending-mode gradients for it (its
  ``use_alpha_blending`` flag never reaches backward.py), and its
  no-blending gradcheck is disabled (tests/test_rasterizer.py:92-101).  We
  stop gradients instead of returning wrong ones.

The Pallas kernels of ``kernels.py`` always run.  ``raster_impl`` is a
hook for the tests and ``chip_smoke.py`` only: it traces the plain XLA
reference of ``ref_lib.raster_plain`` in their place, to compare the two.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data_types import RasterConfig
from ..mapper.tile_mapper import TileMapping, map_to_tiles
from . import kernels


class RasterOut(NamedTuple):
  """Parity with reference RasterOut (function.py:19-24)."""
  image: jnp.ndarray                      # (H, W, F)
  image_weight: jnp.ndarray               # (H, W)
  point_heuristic: Optional[jnp.ndarray]  # (N, 2) — via probe gradient
  visibility: Optional[jnp.ndarray]       # (N,)
  num_overflow: Optional[jnp.ndarray] = None  # () i32 — rows dropped by
  # static capacity clamps when the op built its own mapping (assert == 0;
  # raise max_overlaps / big_capacity otherwise)


# (forward, backward) implementations, keyed by name
_IMPLS = {"pallas": (kernels.forward, kernels.backward)}
_impl = {"forward": "pallas", "backward": "pallas"}


def _impl_fns():
  if "plain" not in _IMPLS:
    from ..ref_lib import raster_plain
    _IMPLS["plain"] = (raster_plain.forward, raster_plain.backward)
  return _IMPLS[_impl["forward"]][0], _IMPLS[_impl["backward"]][1]


@contextlib.contextmanager
def raster_impl(forward: str = "pallas", backward: str = "pallas"):
  """Test hook: trace the rasterizer with the plain reference ("plain")
  in place of the Pallas kernels ("pallas") inside this block.  It applies
  when a function is traced, so jit a fresh function inside the block."""
  old = dict(_impl)
  _impl.update(forward=forward, backward=backward)
  try:
    yield
  finally:
    _impl.update(old)


def _float0(x):
  return np.zeros(x.shape, jax.dtypes.float0)


def _sorted_rows(mapping: TileMapping, gaussians2d, features):
  """(P, 7 + F) rows in sorted overlap order: the mapper's payload when it
  carries these features, else gathered by ``overlap_to_point``."""
  if (mapping.sorted_payload is not None
      and mapping.feature_size == features.shape[1]):
    return mapping.sorted_payload
  rows = jnp.concatenate([gaussians2d, features.astype(gaussians2d.dtype)],
                         -1)
  rows = jnp.concatenate([rows, jnp.zeros((1, rows.shape[1]), rows.dtype)])
  return rows[mapping.overlap_to_point]


@lru_cache(maxsize=None)
def _raster_function(config: RasterConfig, tiles_wide: int, num_points: int,
                     feature_size: int, with_vis: bool, impl: Tuple):
  """Cached custom_vjp rasterizer specialised on static shape/config
  (the jit analogue of the reference's @cache kernel factories,
  function.py:28-40)."""
  n, f = num_points, feature_size
  forward_impl, backward_impl = impl

  @jax.named_scope("raster_forward")
  def run_forward(gaussians2d, features, mapping):
    rows = _sorted_rows(mapping, gaussians2d, features)
    image_tiled, vis_rows = forward_impl(rows, mapping.tile_ranges, config,
                                         tiles_wide, with_vis=with_vis)
    vis = None
    if with_vis:
      vis = kernels.reduce_rows_to_points(jax.lax.stop_gradient(vis_rows),
                                  mapping.overlap_to_point, n)
    return rows, image_tiled, vis

  @jax.custom_vjp
  def raster(gaussians2d, features, probe, mapping):
    _, image_tiled, vis = run_forward(gaussians2d, features, mapping)
    return image_tiled, vis

  def fwd(gaussians2d, features, probe, mapping):
    rows, image_tiled, vis = run_forward(gaussians2d, features, mapping)
    return (image_tiled, vis), (rows, image_tiled, mapping)

  @jax.named_scope("raster_backward")
  def bwd(residuals, cotangents):
    rows, image_tiled, mapping = residuals
    g_image_tiled, _g_vis = cotangents   # visibility is non-differentiable
    grads = backward_impl(rows, mapping.tile_ranges,
                          mapping.overlap_to_point, image_tiled,
                          g_image_tiled, config, tiles_wide, n)
    dtype = rows.dtype
    if config.compute_point_heuristic:
      heur = grads[:, 7 + f:7 + f + 2]
    else:
      heur = jnp.zeros((n, 2), dtype)
    return (grads[:, :7], grads[:, 7:7 + f].astype(dtype),
            heur.astype(dtype), jax.tree.map(_float0, mapping))

  raster.defvjp(fwd, bwd)
  return raster


def detile(image_tiled: jnp.ndarray, tiles_wide: int, tiles_high: int,
           tile_size: int, image_size: Tuple[int, int]) -> jnp.ndarray:
  """(T, C, tile_area) -> (H, W, C)."""
  w_img, h_img = image_size
  c = image_tiled.shape[1]
  t = image_tiled.reshape(tiles_high, tiles_wide, c, tile_size, tile_size)
  full = t.transpose(0, 3, 1, 4, 2).reshape(
      tiles_high * tile_size, tiles_wide * tile_size, c)
  return full[:h_img, :w_img]


def entile(image: jnp.ndarray, tiles_wide: int, tiles_high: int,
           tile_size: int) -> jnp.ndarray:
  """(H, W, C) -> (T, C, tile_area), zero-padding to tile multiples."""
  h, w, c = image.shape
  ph = tiles_high * tile_size - h
  pw = tiles_wide * tile_size - w
  img = jnp.pad(image, ((0, ph), (0, pw), (0, 0)))
  t = img.reshape(tiles_high, tile_size, tiles_wide, tile_size, c)
  return t.transpose(0, 2, 4, 1, 3).reshape(
      tiles_high * tiles_wide, c, tile_size * tile_size)


def tile_mask(image_size: Tuple[int, int], tiles_wide: int,
              tiles_high: int, tile_size: int) -> jnp.ndarray:
  """(T, 1, PIX) f32 mask of pixels inside the image — for computing
  losses directly in tile layout (pad pixels carry rendered content but
  must not contribute)."""
  w, h = image_size
  ones = jnp.ones((h, w, 1), jnp.float32)
  return entile(ones, tiles_wide, tiles_high, tile_size)


def rasterize_tiled(gaussians2d: jnp.ndarray, features: jnp.ndarray,
                    mapping: TileMapping, config: RasterConfig,
                    heuristic_probe: Optional[jnp.ndarray] = None):
  """Rasterize into tile layout.

  Returns (image_tiled (T, F + 1, tile_area) with the alpha image as the
  last channel, visibility (N,) or None)."""
  n, f = features.shape
  assert gaussians2d.shape == (n, 7), gaussians2d.shape
  if heuristic_probe is None:
    heuristic_probe = jnp.zeros((n, 2), gaussians2d.dtype)
  with_vis = config.compute_visibility or config.compute_point_heuristic
  raster = _raster_function(config, mapping.tiles_wide, n, f, with_vis,
                            _impl_fns())
  image_tiled, vis = raster(gaussians2d, features, heuristic_probe, mapping)
  if not config.use_alpha_blending:
    image_tiled = jax.lax.stop_gradient(image_tiled)
  return image_tiled, vis


def rasterize_with_tiles(
    gaussians2d: jnp.ndarray,    # (N, 7)
    features: jnp.ndarray,       # (N, F)
    mapping: TileMapping,
    image_size: Tuple[int, int],
    config: RasterConfig,
    heuristic_probe: Optional[jnp.ndarray] = None,   # (N, 2)
) -> RasterOut:
  """Rasterize with a precomputed tile mapping (reference function.py:100-131).

  If the mapping was built with ``features`` (the fast path used by
  ``rasterize``/``render_gaussians``), its sorted payload feeds the kernels
  directly; otherwise the rows are gathered from the arguments.  Callers
  must pass the same arrays the mapping was built from.

  ``heuristic_probe`` is an all-zeros (N, 2) array; its gradient under any
  loss equals the reference's point heuristics (prune_cost, split_score).
  """
  f = features.shape[1]
  image_tiled, vis = rasterize_tiled(gaussians2d, features, mapping, config,
                                     heuristic_probe)
  full = detile(image_tiled, mapping.tiles_wide, mapping.tiles_high,
                config.tile_size, image_size)
  return RasterOut(image=full[..., :f], image_weight=full[..., f],
                   point_heuristic=None, visibility=vis)


def rasterize(gaussians2d: jnp.ndarray, depth: jnp.ndarray,
              features: jnp.ndarray, image_size: Tuple[int, int],
              config: RasterConfig, use_depth16: bool = False,
              max_overlaps: Optional[int] = None,
              heuristic_probe: Optional[jnp.ndarray] = None) -> RasterOut:
  """Map to tiles + rasterize (reference function.py:133-165)."""
  assert gaussians2d.shape[0] == depth.shape[0] == features.shape[0]
  mapping = map_to_tiles(
      jax.lax.stop_gradient(gaussians2d), jax.lax.stop_gradient(depth),
      image_size=image_size, config=config, max_overlaps=max_overlaps,
      use_depth16=use_depth16,
      features=jax.lax.stop_gradient(features))
  return rasterize_with_tiles(
      gaussians2d, features, mapping, image_size=image_size, config=config,
      heuristic_probe=heuristic_probe)._replace(
          num_overflow=mapping.num_overflow)
