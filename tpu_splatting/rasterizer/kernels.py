"""GPU kernels for tile-based alpha-compositing rasterization (Pallas, Triton).

The layout is the reference CUDA rasterizer's
(taichi_splatting/rasterizer/forward.py:43-84, backward.py:50-227): one
program per image tile, each walking its own depth-sorted overlap range
``tile_ranges[t]`` of the mapper's sorted rows, with the tile's pixels held
in registers.  Rows are loaded in blocks of ``BLOCK`` with masks (no
alignment or padding of the sorted domain is needed), and a program stops
as soon as every pixel of its tile is saturated.  Per-row outputs start as
zeros (an aliased zero input), so the rows a program never reaches, past
its stop or outside every tile range, contribute nothing when reduced to
points.

Within a block, compositing runs in log-transmittance space: the exclusive
cumulative sum of ``log(1 - alpha)`` down the block gives every row's
transmittance at once.  One row per step is the reference's serial
per-point loop; two rows per step measured slightly faster on an H100
(PERF.md, "Kernel choices").  Saturation is a transmittance **freeze**
(``log T <= log(1 - saturate_threshold)`` masks every later contribution),
applied identically in forward and backward, so the custom_vjp is the exact
gradient of the forward (the reference's backward applies this stop,
backward.py:154-160, while its forward does not).

The backward walks the rows front to back again with the reference's
"remaining feature" trick (backward.py:166-196) in scan form: a running
``s = sum_c g_c * remaining_c`` per pixel, seeded from the forward image,
replaces the per-pixel remaining-feature vectors.  The kernel writes one
gradient row per overlap and XLA's scatter-add reduces them to points;
this measured faster than the reference's per-point atomics
(backward.py:199-224) done in the kernel.

On the CPU the same kernels run in Pallas interpret mode (tests, f64
gradchecks); ``ref_lib.raster_plain`` is the plain XLA version of both.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..data_types import RasterConfig
from ..utils.interpret import use_interpret

# Overlap rows composited per loop step, and warps per tile program, as
# measured fastest on an H100 (PERF.md, "Kernel choices").
BLOCK = 2
FORWARD_WARPS = 1
BACKWARD_WARPS = 2

_NEG_BIG = -3.0e38   # "log 0" fill that stays finite in f32 arithmetic


def log_cut(config: RasterConfig) -> float:
  """log(1 - saturate_threshold): the transmittance freeze cut in log space.
  A non-positive cut (saturate_threshold >= 1) disables freezing."""
  cut = 1.0 - config.saturate_threshold
  return math.log(cut) if cut > 0.0 else _NEG_BIG


def _pixel_centres(t, tile_size: int, tiles_wide: int, dtype):
  """(1, PIX) image-space pixel centres of tile ``t``."""
  p = jax.lax.broadcasted_iota(jnp.int32, (1, tile_size * tile_size), 1)
  px = (t % tiles_wide) * tile_size + p % tile_size
  py = (t // tiles_wide) * tile_size + p // tile_size
  return px.astype(dtype) + 0.5, py.astype(dtype) + 0.5


def _load_block(rows_ref, j, end, width: int, block: int = BLOCK):
  """Rows [j, j + block) of the sorted domain as (block, 1) columns; rows
  at or past ``end`` load as zeros and are flagged invalid."""
  r = j + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
  valid = r < end
  cols = [plgpu.load(rows_ref.at[pl.ds(j, block), c], mask=valid,
                     other=0.0)[:, None]
          for c in range(width)]
  return valid, cols


def _s_sig(x, s):
  z = x / s
  return 1.0 / (1.0 + jnp.exp(-1.6 * z - 0.07 * z * z * z))


class _Alpha:
  """Per (row, pixel) compositing alpha of a block, with the geometry the
  backward differentiates (generic.py:347-357 for the antialiased pdf)."""

  def __init__(self, cols, px, py, valid, config: RasterConfig):
    mx, my, ax, ay, sx, sy, pa = cols[:7]
    # null rows load as zeros: clamp sigma so every term stays finite
    self.sx = jnp.maximum(sx, 1e-12)
    self.sy = jnp.maximum(sy, 1e-12)
    self.ax, self.ay, self.pa = ax, ay, pa
    self.dx = px - mx
    self.dy = py - my
    self.tu = self.dx * ax + self.dy * ay
    self.tv = self.dy * ax - self.dx * ay
    if config.antialias:
      ix = self.sx * (_s_sig(self.tu + 0.5, self.sx)
                      - _s_sig(self.tu - 0.5, self.sx))
      iy = self.sy * (_s_sig(self.tv + 0.5, self.sy)
                      - _s_sig(self.tv - 0.5, self.sy))
      self.pdf = (2.0 * jnp.pi) * ix * iy
    else:
      self.u = self.tu / self.sx
      self.v = self.tv / self.sy
      self.pdf = jnp.exp(-0.5 * (self.u * self.u + self.v * self.v))
    self.a_raw = pa * self.pdf
    self.a = jnp.where((self.a_raw > config.alpha_threshold)
                       & valid[:, None],
                       jnp.minimum(self.a_raw, config.clamp_max_alpha), 0.0)


def _composite(alpha: _Alpha, lt):
  """Log-space compositing of one block: per-row log-transmittance before
  each row, and the block's total log(1 - alpha) per pixel."""
  l = jnp.log1p(-alpha.a)
  incl = jnp.cumsum(l, axis=0)
  return lt[None, :] + (incl - l), jnp.sum(l, axis=0)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _forward_kernel(ranges_ref, rows_ref, *refs, config: RasterConfig,
                    tiles_wide: int, f: int):
  # with visibility: (zero vis input, image, vis), else (image,)
  img_ref, vis_ref = refs[-2:] if len(refs) == 3 else (refs[0], None)
  t = pl.program_id(0)
  start = ranges_ref[t, 0]
  end = ranges_ref[t, 1]
  dtype = rows_ref.dtype
  pix = config.tile_area
  px, py = _pixel_centres(t, config.tile_size, tiles_wide, dtype)
  blend = config.use_alpha_blending
  lcut = log_cut(config)

  def cond(carry):
    j, lt = carry[0], carry[1]
    if not blend:
      return j < end
    return (j < end) & (jnp.max(lt) > lcut)

  def body(carry):
    j, lt, *acc = carry
    valid, cols = _load_block(rows_ref, j, end, 7 + f)
    alpha = _Alpha(cols, px, py, valid, config)
    lt_i, l_sum = _composite(alpha, lt)
    t_i = jnp.exp(lt_i)
    if blend:
      w = jnp.where(lt_i > lcut, alpha.a * t_i, 0.0)
      acc = ([acc[c] + jnp.sum(w * cols[7 + c], axis=0) for c in range(f)]
             + [acc[f] + jnp.sum(w, axis=0)])
    else:
      # quantile mode (forward.py:105-112): the feature of the row where
      # transmittance crosses saturate_threshold; weights are not frozen
      thr = config.saturate_threshold
      w = alpha.a * t_i
      sel = (t_i * (1.0 - alpha.a) <= thr) & (t_i > thr)
      acc = [acc[c] + jnp.sum(jnp.where(sel, cols[7 + c], 0.0), axis=0)
             for c in range(f)]
    if vis_ref is not None:
      plgpu.store(vis_ref.at[pl.ds(j, BLOCK)], jnp.sum(w, axis=1),
                  mask=valid)
    return (j + BLOCK, lt + l_sum, *acc)

  zero = jnp.zeros((pix,), dtype)
  n_acc = f + 1 if blend else f
  _, lt, *acc = jax.lax.while_loop(
      cond, body, (start, zero, *([zero] * n_acc)))
  if not blend:
    acc.append((lt < 0.0).astype(dtype))   # hit mask (forward.py:135)
  for c in range(f + 1):
    img_ref[t, c, :] = acc[c]


def forward(sorted_rows: jnp.ndarray, tile_ranges: jnp.ndarray,
            config: RasterConfig, tiles_wide: int, with_vis: bool = True,
            ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
  """Composite every tile's sorted overlap rows.

  Args:
    sorted_rows: (P, 7 + F) packed gaussian + feature rows, tile-major and
      depth-ordered within each tile.
    tile_ranges: (T, 2) i32 [start, end) of each tile's rows.

  Returns:
    image_tiled: (T, F + 1, tile_area); channel F is the alpha image.
    vis_rows: (P,) per-row sum of blend weights (zero for rows a tile
      never reaches), or None without ``with_vis``.
  """
  assert config.tile_area & (config.tile_area - 1) == 0, (
      "tile_size must be a power of two")
  p, width = sorted_rows.shape
  f = width - 7
  num_tiles = tile_ranges.shape[0]
  dtype = sorted_rows.dtype
  out_shape = [jax.ShapeDtypeStruct((num_tiles, f + 1, config.tile_area),
                                    dtype)]
  args = [tile_ranges, sorted_rows]
  if with_vis:
    out_shape.append(jax.ShapeDtypeStruct((p,), dtype))
    args.append(jnp.zeros((p,), dtype))

  out = pl.pallas_call(
      functools.partial(_forward_kernel, config=config,
                        tiles_wide=tiles_wide, f=f),
      grid=(num_tiles,),
      out_shape=out_shape,
      input_output_aliases={2: 1} if with_vis else {},
      backend="triton",
      compiler_params=plgpu.CompilerParams(num_warps=FORWARD_WARPS,
                                           num_stages=1),
      interpret=use_interpret(),
      name="raster_forward",
  )(*args)
  return out[0], (out[1] if with_vis else None)


# ---------------------------------------------------------------------------
# Backward (alpha-blending mode)
# ---------------------------------------------------------------------------


def _antialias_grads(alpha: _Alpha):
  """d pdf / d (mean, axis, sigma) of the antialiased pdf
  (generic.py:371-404); all (rows, PIX)."""
  tau = 2.0 * jnp.pi
  sx, sy = alpha.sx, alpha.sy

  def s_grads(x, sig):
    z = x / sig
    s_val = 1.0 / (1.0 + jnp.exp(-1.6 * z - 0.07 * z * z * z))
    d_dx = (1.6 + 0.21 * z * z) * s_val * (1.0 - s_val) / sig
    return s_val, d_dx, d_dx * -z

  sx1, dx1, dx1s = s_grads(alpha.tu + 0.5, sx)
  sx2, dx2, dx2s = s_grads(alpha.tu - 0.5, sx)
  sy1, dy1, dy1s = s_grads(alpha.tv + 0.5, sy)
  sy2, dy2, dy2s = s_grads(alpha.tv - 0.5, sy)
  ix = sx * (sx1 - sx2)
  iy = sy * (sy1 - sy2)
  dsx_t = iy * sx * (dx1 - dx2)
  dsy_t = ix * sy * (dy1 - dy2)
  ax, ay, dx, dy = alpha.ax, alpha.ay, alpha.dx, alpha.dy
  return (tau * (-dsx_t * ax + dsy_t * ay),
          tau * (-dsx_t * ay - dsy_t * ax),
          tau * (dsx_t * dx + dsy_t * dy),
          tau * (dsx_t * dy - dsy_t * dx),
          tau * iy * (sx1 - sx2 + (dx1s - dx2s) * sx),
          tau * ix * (sy1 - sy2 + (dy1s - dy2s) * sy))


def _row_gradients(alpha: _Alpha, alpha_grad, w, gimg, config: RasterConfig):
  """Per-row gradient columns [mean, axis, sigma, point alpha, features
  (, prune_cost, split_score)], each (rows,), reduced over the tile's
  pixels (backward.py:180-197)."""
  z = alpha_grad * (alpha.a_raw < config.clamp_max_alpha)   # dL/d a_raw
  zp = z * alpha.pa                                         # dL/d pdf
  if config.antialias:
    d_pdf = _antialias_grads(alpha)
    px_terms = [zp * d for d in d_pdf]
  else:
    zpp = zp * alpha.pdf
    isx = 1.0 / alpha.sx
    isy = 1.0 / alpha.sy
    ax, ay, u, v = alpha.ax, alpha.ay, alpha.u, alpha.v
    px_terms = [zpp * (u * (ax * isx) - v * (ay * isy)),
                zpp * (u * (ay * isx) + v * (ax * isy)),
                -zpp * (u * isx * alpha.dx + v * isy * alpha.dy),
                -zpp * (u * isx * alpha.dy - v * isy * alpha.dx),
                zpp * (u * u) * isx,
                zpp * (v * v) * isy]
  cols = [jnp.sum(x, axis=1) for x in px_terms]
  cols.append(jnp.sum(z * alpha.pdf, axis=1))
  cols += [jnp.sum(w * g, axis=1) for g in gimg[:-1]]
  if config.compute_point_heuristic:
    aag = alpha.pa * alpha_grad
    cols.append(jnp.sum(aag * aag, axis=1))
    cols.append(jnp.sum(jnp.abs(px_terms[0]) + jnp.abs(px_terms[1]),
                        axis=1))
  return cols


def _backward_kernel(ranges_ref, rows_ref, img_ref, gimg_ref, _zeros_ref,
                     out_ref, *, config: RasterConfig, tiles_wide: int,
                     f: int):
  t = pl.program_id(0)
  start = ranges_ref[t, 0]
  end = ranges_ref[t, 1]
  dtype = rows_ref.dtype
  px, py = _pixel_centres(t, config.tile_size, tiles_wide, dtype)
  lcut = log_cut(config)

  gimg = [gimg_ref[t, c, :] for c in range(f + 1)]          # (PIX,) each
  s0 = gimg[0] * img_ref[t, 0, :]
  for c in range(1, f + 1):
    s0 = s0 + gimg[c] * img_ref[t, c, :]

  def cond(carry):
    j, lt, _ = carry
    return (j < end) & (jnp.max(lt) > lcut)

  def body(carry):
    j, lt, s = carry
    valid, cols = _load_block(rows_ref, j, end, 7 + f)
    alpha = _Alpha(cols, px, py, valid, config)
    lt_i, l_sum = _composite(alpha, lt)
    live = (lt_i > lcut) & (alpha.a > 0.0)
    t_i = jnp.exp(lt_i)
    w = jnp.where(live, alpha.a * t_i, 0.0)
    # d pixel / d weight: features plus the alpha channel (feature 1)
    gf = gimg[f][None, :] + cols[7] * gimg[0][None, :]
    for c in range(1, f):
      gf = gf + cols[7 + c] * gimg[c][None, :]
    wgf = w * gf
    s_i = s[None, :] - jnp.cumsum(wgf, axis=0)   # remaining after each row
    alpha_grad = jnp.where(live, t_i * gf - s_i / (1.0 - alpha.a), 0.0)

    grads = _row_gradients(alpha, alpha_grad, w, gimg, config)
    for c, g in enumerate(grads):
      plgpu.store(out_ref.at[pl.ds(j, BLOCK), jnp.int32(c)], g, mask=valid)
    return j + BLOCK, lt + l_sum, s - jnp.sum(wgf, axis=0)

  zero = jnp.zeros((config.tile_area,), dtype)
  jax.lax.while_loop(cond, body, (start, zero, s0))


def reduce_rows_to_points(rows: jnp.ndarray, point_ids: jnp.ndarray,
                          num_points: int) -> jnp.ndarray:
  """Sum per-overlap rows into their points (XLA scatter-add); ids at or
  past ``num_points`` (overlap slots outside every tile range) are
  dropped."""
  return jax.ops.segment_sum(rows, point_ids, num_points)


def grad_width(config: RasterConfig, f: int) -> int:
  """Columns of the per-point gradient: [mean(2), axis(2), sigma(2),
  alpha, features(F)] plus [prune_cost, split_score] with heuristics."""
  return 7 + f + (2 if config.compute_point_heuristic else 0)


def backward(sorted_rows: jnp.ndarray, tile_ranges: jnp.ndarray,
             overlap_to_point: jnp.ndarray, image_tiled: jnp.ndarray,
             g_image_tiled: jnp.ndarray, config: RasterConfig,
             tiles_wide: int, num_points: int) -> jnp.ndarray:
  """Gradients of the blended image w.r.t. every point: one gradient row
  per overlap from the kernel, summed into points by XLA's scatter-add.

  Returns (num_points, grad_width(config, F)) per-point gradient rows.
  """
  p, width = sorted_rows.shape
  f = width - 7
  num_tiles = tile_ranges.shape[0]
  out_shape = jax.ShapeDtypeStruct((p, grad_width(config, f)),
                                   sorted_rows.dtype)
  rows = pl.pallas_call(
      functools.partial(_backward_kernel, config=config,
                        tiles_wide=tiles_wide, f=f),
      grid=(num_tiles,),
      out_shape=out_shape,
      input_output_aliases={4: 0},   # rows past a tile's stop stay zero
      backend="triton",
      compiler_params=plgpu.CompilerParams(num_warps=BACKWARD_WARPS,
                                           num_stages=1),
      interpret=use_interpret(),
      name="raster_backward",
  )(tile_ranges, sorted_rows, image_tiled, g_image_tiled,
    jnp.zeros(out_shape.shape, out_shape.dtype))
  return reduce_rows_to_points(rows, overlap_to_point, num_points)
