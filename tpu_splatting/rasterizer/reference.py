"""Sequential per-point rasterization oracle (numpy f64, test ground truth).

Plays the role of the reference's torch_lib comparison layer (SURVEY.md §4):
a deliberately naive implementation of exactly the semantics the kernels
implement — front-to-back alpha compositing, one point at a time, with
threshold masking, alpha clamping and transmittance-freeze saturation, plus
the quantile (non-blending) mode and per-point visibility.  Each step is
vectorised over one tile's pixels only; use it on tiny scenes, or on a few
sampled tiles of a large one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..data_types import RasterConfig
from ..mapper.tile_mapper import TileMapping, tile_shape


def _pdf(px, py, g, antialias):
  mean_x, mean_y, ax, ay, sx, sy, _ = g
  dx, dy = px - mean_x, py - mean_y
  tu = dx * ax + dy * ay
  tv = -dx * ay + dy * ax
  if not antialias:
    return np.exp(-0.5 * ((tu / sx) ** 2 + (tv / sy) ** 2))

  def s_sig(x, s):
    z = x / s
    return 1.0 / (1.0 + np.exp(-1.6 * z - 0.07 * z ** 3))

  ix = sx * (s_sig(tu + 0.5, sx) - s_sig(tu - 0.5, sx))
  iy = sy * (s_sig(tv + 0.5, sy) - s_sig(tv - 0.5, sy))
  return 2.0 * np.pi * ix * iy


def _render_tile(tile, gaussians2d, features, point_ids, tiles_wide,
                 config: RasterConfig, visibility):
  """(PIX, F) image and (PIX,) alpha of one tile; adds to visibility."""
  ts = config.tile_size
  p = np.arange(ts * ts)
  px = (tile % tiles_wide) * ts + p % ts + 0.5
  py = (tile // tiles_wide) * ts + p // ts + 0.5
  f = features.shape[1]
  t_run = np.ones(ts * ts)
  accum = np.zeros((ts * ts, f))
  total = np.zeros(ts * ts)
  crossed = np.zeros(ts * ts, bool)
  cut = 1.0 - config.saturate_threshold

  for pid in point_ids:
    g = gaussians2d[pid]
    a = np.minimum(g[6] * _pdf(px, py, g, config.antialias),
                   config.clamp_max_alpha)
    live = a > config.alpha_threshold
    if config.use_alpha_blending:
      live &= t_run > cut                     # transmittance freeze
      w = np.where(live, a * t_run, 0.0)
      accum += w[:, None] * features[pid]
    else:
      # quantile mode: no freeze; the feature at the first crossing
      w = np.where(live, a * t_run, 0.0)
      t_new = np.where(live, t_run * (1.0 - a), t_run)
      sel = (live & (t_new <= config.saturate_threshold)
             & (t_run > config.saturate_threshold) & ~crossed)
      accum[sel] = features[pid]
      crossed |= sel
    total += w
    visibility[pid] += w.sum()
    t_run = np.where(live, t_run * (1.0 - a), t_run)

  if config.use_alpha_blending:
    return accum, total
  return accum, (t_run < 1.0).astype(np.float64)


def rasterize_reference(gaussians2d, features, mapping: TileMapping,
                        image_size: Tuple[int, int], config: RasterConfig,
                        tiles: Optional[Sequence[int]] = None):
  """Returns (image (H,W,F), image_alpha (H,W), visibility (N,)).

  With ``tiles``, only those tiles are rendered and the images come back
  per tile: (len(tiles), tile_area, F) and (len(tiles), tile_area)."""
  gaussians2d = np.asarray(gaussians2d, np.float64)
  features = np.asarray(features, np.float64)
  o2p = np.asarray(mapping.overlap_to_point)
  ranges = np.asarray(mapping.tile_ranges)
  n, f = features.shape
  ts = config.tile_size
  tw, th = tile_shape(image_size, ts)
  visibility = np.zeros(n)

  todo = range(tw * th) if tiles is None else tiles
  images, alphas = [], []
  for tile in todo:
    s, e = ranges[tile]
    img, alpha = _render_tile(tile, gaussians2d, features, o2p[s:e], tw,
                              config, visibility)
    images.append(img)
    alphas.append(alpha)
  images = np.stack(images)
  alphas = np.stack(alphas)
  if tiles is not None:
    return images, alphas, visibility

  w_img, h_img = image_size
  image = images.reshape(th, tw, ts, ts, f).transpose(0, 2, 1, 3, 4)
  alpha = alphas.reshape(th, tw, ts, ts).transpose(0, 2, 1, 3)
  return (image.reshape(th * ts, tw * ts, f)[:h_img, :w_img],
          alpha.reshape(th * ts, tw * ts)[:h_img, :w_img], visibility)
