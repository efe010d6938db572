"""Plain XLA rasterizer over the mapper's sorted rows (forward + backward).

The same semantics as the Pallas kernels (``rasterizer/kernels.py``) in
``jax.numpy``/``lax`` only, written independently of them: each tile's
rows are cut into chunks of ``CHUNK`` rows, every chunk is composited in
parallel in log-transmittance space, and the chunks of one tile are chained
by a segmented scan over their per-pixel totals.  Chunks are processed in
batches with ``lax.map`` so that the (chunk, row, pixel) intermediates fit
in device memory.  The backward differentiates the per-pixel alpha with
``jax.vjp``/``jax.jvp`` instead of hand-written derivatives.

It has the same interface as the kernels, so the tests and the on-card
check trace it in their place (``rasterizer.function.raster_impl``) and
compare the two.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..data_types import RasterConfig

CHUNK = 32
# (chunk, row, pixel) elements per lax.map step
_BATCH_ELEMS = 1 << 25


def _log_cut(config: RasterConfig) -> float:
  cut = 1.0 - config.saturate_threshold
  return math.log(cut) if cut > 0.0 else -3.0e38


class _Chunks:
  """Chunk layout of the sorted rows: chunk k holds rows
  [src[k], src[k] + cnt[k]) of tile ``tile[k]``; chunks of a tile are
  consecutive, padding chunks have tile == T and cnt == 0."""

  def __init__(self, tile_ranges, num_rows: int, pix: int):
    g = CHUNK
    t = tile_ranges.shape[0]
    start, end = tile_ranges[:, 0], tile_ranges[:, 1]
    per_tile = (end - start + g - 1) // g
    ends = jnp.cumsum(per_tile)
    k = -(-num_rows // g) + t                 # static bound on the count
    self.batch = max(1, min(k, _BATCH_ELEMS // (g * pix)))
    k = -(-k // self.batch) * self.batch
    ids = jnp.arange(k, dtype=jnp.int32)
    tile = jnp.searchsorted(ends, ids, side="right").astype(jnp.int32)
    tc = jnp.minimum(tile, t - 1)
    src = start[tc] + (ids - (ends[tc] - per_tile[tc])) * g
    self.tile = tile
    self.src = src
    self.cnt = jnp.where(tile < t, jnp.clip(end[tc] - src, 0, g), 0)
    self.num_tiles = t
    self.num_rows = num_rows

  def row_index(self):
    """(K, CHUNK) sorted-row index per chunk slot (clipped) and validity."""
    r = jnp.arange(CHUNK, dtype=jnp.int32)
    valid = r[None, :] < self.cnt[:, None]
    idx = jnp.clip(self.src[:, None] + r[None, :], 0, self.num_rows - 1)
    return idx, valid

  def batched(self, *xs):
    """Split leading-K arrays into (K / batch, batch, ...) for lax.map."""
    return tuple(x.reshape(-1, self.batch, *x.shape[1:]) for x in xs)


def _pixels(tile, tile_size: int, tiles_wide: int, dtype):
  """(B, 1, PIX) pixel centres of each chunk's tile."""
  p = jnp.arange(tile_size * tile_size, dtype=jnp.int32)
  px = (tile % tiles_wide)[:, None] * tile_size + p % tile_size
  py = (tile // tiles_wide)[:, None] * tile_size + p // tile_size
  return ((px.astype(dtype) + 0.5)[:, None, :],
          (py.astype(dtype) + 0.5)[:, None, :])


def _alpha_raw(g7, px, py, antialias: bool):
  """point alpha * pdf for rows (B, G, 7) at pixels (B, 1, PIX)."""
  mx, my, ax, ay, sx, sy, pa = (g7[..., i:i + 1] for i in range(7))
  sx = jnp.maximum(sx, 1e-12)
  sy = jnp.maximum(sy, 1e-12)
  dx, dy = px - mx, py - my
  tu = dx * ax + dy * ay
  tv = dy * ax - dx * ay
  if antialias:
    def s_sig(x, s):
      z = x / s
      return jax.nn.sigmoid(1.6 * z + 0.07 * z ** 3)
    ix = sx * (s_sig(tu + 0.5, sx) - s_sig(tu - 0.5, sx))
    iy = sy * (s_sig(tv + 0.5, sy) - s_sig(tv - 0.5, sy))
    pdf = 2.0 * jnp.pi * ix * iy
  else:
    pdf = jnp.exp(-0.5 * ((tu / sx) ** 2 + (tv / sy) ** 2))
  return pa * pdf


def _clamp(a_raw, valid, config: RasterConfig):
  live = (a_raw > config.alpha_threshold) & valid[..., None]
  return jnp.where(live, jnp.minimum(a_raw, config.clamp_max_alpha), 0.0)


def _segment_exclusive_cumsum(x, tile):
  """Exclusive cumulative sum of (K, ...) x within runs of equal tile."""
  first = jnp.concatenate([jnp.ones((1,), bool), tile[1:] != tile[:-1]])

  def op(a, b):
    fa, va = a
    fb, vb = b
    fb_ = fb.reshape(fb.shape + (1,) * (vb.ndim - fb.ndim))
    return fa | fb, jnp.where(fb_, vb, va + vb)

  _, incl = jax.lax.associative_scan(op, (first, x))
  return incl - x


class _Step:
  """Per-batch quantities shared by the passes."""

  def __init__(self, rows, chunks_b, config: RasterConfig, tiles_wide: int):
    tile, idx, valid = chunks_b
    self.valid = valid
    self.block = jnp.where(valid[..., None], rows[idx], 0.0)   # (B, G, W)
    self.px, self.py = _pixels(tile, config.tile_size, tiles_wide,
                               rows.dtype)
    self.a_raw = _alpha_raw(self.block[..., :7], self.px, self.py,
                            config.antialias)
    self.a = _clamp(self.a_raw, valid, config)
    self.l = jnp.log1p(-self.a)

  def log_t(self, lt_in):
    """(B, G, PIX) log transmittance before each row."""
    return lt_in[:, None, :] + jnp.cumsum(self.l, axis=1) - self.l


def _log_t_in(rows, chunks: _Chunks, config, tiles_wide, b_idx, b_valid):
  """(K, PIX) log transmittance at the start of every chunk."""
  def sums(xs):
    return jnp.sum(_Step(rows, xs, config, tiles_wide).l, axis=1)
  tb, = chunks.batched(chunks.tile)
  l_sum = jax.lax.map(sums, (tb, b_idx, b_valid)).reshape(
      -1, config.tile_area)
  return _segment_exclusive_cumsum(l_sum, chunks.tile), l_sum


def forward(sorted_rows: jnp.ndarray, tile_ranges: jnp.ndarray,
            config: RasterConfig, tiles_wide: int, with_vis: bool = True,
            ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
  """Same contract as ``rasterizer.kernels.forward``."""
  p, width = sorted_rows.shape
  f = width - 7
  pix = config.tile_area
  t = tile_ranges.shape[0]
  chunks = _Chunks(tile_ranges, p, pix)
  idx, valid = chunks.row_index()
  b_tile, b_idx, b_valid = chunks.batched(chunks.tile, idx, valid)
  lt_in, l_sum = _log_t_in(sorted_rows, chunks, config, tiles_wide, b_idx,
                           b_valid)
  lcut = _log_cut(config)
  blend = config.use_alpha_blending

  def composite(xs):
    tile, bi, bv, lt0 = xs
    st = _Step(sorted_rows, (tile, bi, bv), config, tiles_wide)
    lt = st.log_t(lt0)
    t_i = jnp.exp(lt)
    feats = st.block[..., 7:]
    if blend:
      w = jnp.where(lt > lcut, st.a * t_i, 0.0)
      frow = jnp.concatenate([feats, jnp.ones_like(feats[..., :1])], -1)
      contrib = jnp.sum(w[:, :, None, :] * frow[..., None], axis=1)
    else:
      thr = config.saturate_threshold
      w = st.a * t_i
      sel = (t_i * (1.0 - st.a) <= thr) & (t_i > thr)
      contrib = jnp.sum(jnp.where(sel[:, :, None, :], feats[..., None], 0.0),
                        axis=1)
    return contrib, jnp.sum(w, axis=2)

  lt_b, = chunks.batched(lt_in)
  contrib, vis = jax.lax.map(composite, (b_tile, b_idx, b_valid, lt_b))
  contrib = contrib.reshape(-1, *contrib.shape[2:])
  image = jax.ops.segment_sum(contrib, chunks.tile, t)
  if not blend:
    hit = jax.ops.segment_sum(l_sum, chunks.tile, t) < 0.0
    image = jnp.concatenate([image, hit[:, None, :].astype(image.dtype)], 1)
  vis_rows = None
  if with_vis:
    dest = jnp.where(valid, idx, p).reshape(-1)
    vis_rows = jnp.zeros((p,), sorted_rows.dtype).at[dest].set(
        vis.reshape(-1), mode="drop")
  return image, vis_rows


def backward(sorted_rows: jnp.ndarray, tile_ranges: jnp.ndarray,
             overlap_to_point: jnp.ndarray, image_tiled: jnp.ndarray,
             g_image_tiled: jnp.ndarray, config: RasterConfig,
             tiles_wide: int, num_points: int) -> jnp.ndarray:
  """Same contract as ``rasterizer.kernels.backward``."""
  p, width = sorted_rows.shape
  f = width - 7
  pix = config.tile_area
  chunks = _Chunks(tile_ranges, p, pix)
  idx, valid = chunks.row_index()
  b_tile, b_idx, b_valid = chunks.batched(chunks.tile, idx, valid)
  lt_in, _ = _log_t_in(sorted_rows, chunks, config, tiles_wide, b_idx,
                       b_valid)
  lcut = _log_cut(config)
  tc = jnp.minimum(chunks.tile, chunks.num_tiles - 1)

  def terms(xs):
    tile, bi, bv, lt0 = xs
    st = _Step(sorted_rows, (tile, bi, bv), config, tiles_wide)
    lt = st.log_t(lt0)
    live = (lt > lcut) & (st.a > 0.0)
    t_i = jnp.exp(lt)
    w = jnp.where(live, st.a * t_i, 0.0)
    gimg = g_image_tiled[jnp.minimum(tile, chunks.num_tiles - 1)]
    gf = jnp.einsum("bgc,bcp->bgp", st.block[..., 7:], gimg[:, :f],
                    precision=jax.lax.Precision.HIGHEST) + gimg[:, None, f]
    return st, live, t_i, w, gf, gimg

  def wg_sums(xs):
    _, _, _, w, gf, _ = terms(xs)
    return jnp.sum(w * gf, axis=1)

  lt_b, = chunks.batched(lt_in)
  wg = jax.lax.map(wg_sums, (b_tile, b_idx, b_valid, lt_b)).reshape(-1, pix)
  s_tile = jnp.sum(g_image_tiled * image_tiled, axis=1)       # (T, PIX)
  s_in = s_tile[tc] - _segment_exclusive_cumsum(wg, chunks.tile)

  def grads(xs):
    tile, bi, bv, lt0, s0 = xs
    st, live, t_i, w, gf, gimg = terms((tile, bi, bv, lt0))
    s_i = s0[:, None, :] - jnp.cumsum(w * gf, axis=1)
    alpha_grad = jnp.where(live, t_i * gf - s_i / (1.0 - st.a), 0.0)
    z = alpha_grad * (st.a_raw < config.clamp_max_alpha)
    g7 = st.block[..., :7]

    def a_of(g7_):
      return _alpha_raw(g7_, st.px, st.py, config.antialias)

    _, vjp = jax.vjp(a_of, g7)
    (g_geo,) = vjp(z)
    g_feat = jnp.einsum("bgp,bcp->bgc", w, gimg[:, :f],
                        precision=jax.lax.Precision.HIGHEST)
    cols = [g_geo, g_feat]
    if config.compute_point_heuristic:
      pa = g7[..., 6:7]
      prune = jnp.sum((pa * alpha_grad) ** 2, axis=2)

      def d_a(c):
        e = jnp.zeros_like(g7).at[..., c].set(1.0)
        return jax.jvp(a_of, (g7,), (e,))[1]

      split = jnp.sum(jnp.abs(z * d_a(0)) + jnp.abs(z * d_a(1)), axis=2)
      cols.append(jnp.stack([prune, split], -1))
    return jnp.concatenate(cols, -1)

  s_b, = chunks.batched(s_in)
  rows_g = jax.lax.map(grads, (b_tile, b_idx, b_valid, lt_b, s_b))
  pid = jnp.where(valid, overlap_to_point[idx], num_points).reshape(-1)
  return jax.ops.segment_sum(rows_g.reshape(pid.shape[0], -1), pid,
                             num_points)
