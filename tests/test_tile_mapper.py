"""Tile mapper tests: brute-force OBB membership oracle + layout invariants
(mirrors the reference's mapper semantics, tile_mapper.py:27-198)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_splatting import RasterConfig
from tpu_splatting.mapper.tile_mapper import map_to_tiles, tile_shape
from tpu_splatting.misc.renderer2d import project_gaussians2d

from random_data import random_2d_gaussians


def brute_force_overlaps(gaussians, depth, image_size, config):
  """O(N*T) oracle: exact separating-axis test of every (gaussian, tile)."""
  ts = config.tile_size
  tw, th = tile_shape(image_size, ts)
  g = np.asarray(gaussians, dtype=np.float64)
  depth = np.asarray(depth, dtype=np.float64).reshape(-1)

  mean, axis, sigma, alpha = g[:, 0:2], g[:, 2:4], g[:, 4:6], g[:, 6]
  overlaps = set()
  for i in range(g.shape[0]):
    if alpha[i] <= config.alpha_threshold or depth[i] <= 0:
      continue
    gscale2 = 2 * np.log(alpha[i] / config.alpha_threshold)
    if gscale2 <= 0:
      continue
    gscale = np.sqrt(gscale2)
    scale = sigma[i] * gscale
    a1, a2 = axis[i], np.array([-axis[i][1], axis[i][0]])
    u1, u2 = a1 / max(scale[0], 1e-12), a2 / max(scale[1], 1e-12)

    # conservative AABB tile range (grid_query.py:9-27)
    extent = np.sqrt((a1 * scale[0]) ** 2 + (a2 * scale[1]) ** 2)
    lower, upper = mean[i] - extent, mean[i] + extent
    max_tile = (np.array([tw * ts, th * ts]) - 1) // ts
    mn = np.maximum(np.floor(lower / ts).astype(int), 0)
    mx = np.ceil(upper / ts).astype(int)
    mx = np.minimum(np.maximum(mx, mn + 1), max_tile + 1)

    for ty in range(mn[1], mx[1]):
      for tx in range(mn[0], mx[0]):
        # corner-based separating axis test (grid_query.py:30-43)
        corners = np.array([[tx * ts, ty * ts], [(tx + 1) * ts, ty * ts],
                            [(tx + 1) * ts, (ty + 1) * ts],
                            [tx * ts, (ty + 1) * ts]]) - mean[i]
        p1 = corners @ u1
        p2 = corners @ u2
        separates = (p1.min() > 1 or p1.max() < -1 or
                     p2.min() > 1 or p2.max() < -1)
        if not separates:
          overlaps.add((ty * tw + tx, i))
  return overlaps


@pytest.mark.parametrize("seed", range(8))
def test_mapper_matches_oracle(seed):
  rng = np.random.default_rng(seed)
  image_size = (64, 48)
  config = RasterConfig(tile_size=16)
  gaussians2d = random_2d_gaussians(rng, 60, image_size, scale_factor=0.5)
  packed = project_gaussians2d(gaussians2d)
  depth = gaussians2d.depths

  mapping = map_to_tiles(packed, depth, image_size, config, max_overlaps=4096)
  assert int(mapping.num_overflow) == 0

  expected = brute_force_overlaps(packed, depth, image_size, config)

  # reconstruct (tile, point) pairs from the sorted overlap list
  o2p = np.asarray(mapping.overlap_to_point)
  ranges = np.asarray(mapping.tile_ranges)
  got = set()
  for t in range(mapping.num_tiles):
    s, e = ranges[t]
    for k in range(s, e):
      got.add((t, int(o2p[k])))

  assert got == expected


@pytest.mark.parametrize("seed", range(4))
def test_mapper_depth_sorted_and_chunk_layout(seed):
  rng = np.random.default_rng(seed + 100)
  image_size = (96, 64)
  config = RasterConfig(tile_size=16)
  gaussians2d = random_2d_gaussians(rng, 100, image_size, scale_factor=0.8)
  packed = project_gaussians2d(gaussians2d)
  depth = np.asarray(gaussians2d.depths)

  mapping = map_to_tiles(packed, jnp.asarray(depth), image_size, config,
                         max_overlaps=8192)
  o2p = np.asarray(mapping.overlap_to_point)
  ranges = np.asarray(mapping.tile_ranges)
  n = mapping.num_points

  # depth sorted (front to back) within every tile
  for t in range(mapping.num_tiles):
    s, e = ranges[t]
    d = depth[o2p[s:e]]
    assert np.all(np.diff(d) >= 0), f"tile {t} not depth sorted"

  # range layout: tiles own consecutive, back-to-back ranges from row 0;
  # rows past the last range are null (point id n)
  assert ranges[0, 0] == 0
  np.testing.assert_array_equal(ranges[1:, 0], ranges[:-1, 1])
  total = ranges[-1, 1]
  assert np.all(o2p[:total] < n) and np.all(o2p[total:] == n)


def test_mapper_payload_rows():
  """The sorted payload is each overlap's packed gaussian + feature row."""
  rng = np.random.default_rng(3)
  image_size = (64, 48)
  config = RasterConfig(tile_size=16)
  gaussians2d = random_2d_gaussians(rng, 40, image_size, scale_factor=0.8)
  packed = project_gaussians2d(gaussians2d)
  mapping = map_to_tiles(packed, gaussians2d.depths, image_size, config,
                         max_overlaps=2048, features=gaussians2d.feature)
  total = int(mapping.tile_ranges[-1, 1])
  o2p = np.asarray(mapping.overlap_to_point)[:total]
  rows = np.concatenate([np.asarray(packed), np.asarray(gaussians2d.feature)],
                        -1)
  np.testing.assert_array_equal(np.asarray(mapping.sorted_payload)[:total],
                                rows[o2p])


def test_mapper_overflow_reported():
  rng = np.random.default_rng(0)
  image_size = (64, 64)
  config = RasterConfig(tile_size=16)
  gaussians2d = random_2d_gaussians(rng, 200, image_size, scale_factor=2.0)
  packed = project_gaussians2d(gaussians2d)

  small = map_to_tiles(packed, gaussians2d.depths, image_size, config,
                       max_overlaps=64)
  assert int(small.num_overflow) > 0

  big = map_to_tiles(packed, gaussians2d.depths, image_size, config,
                     max_overlaps=16384)
  assert int(big.num_overflow) == 0


def test_mapper_big_gaussian_path():
  """A gaussian spanning more tiles than the small window must still map to
  all its tiles via the big path."""
  config = RasterConfig(tile_size=16, tile_window=4)
  image_size = (256, 256)  # 16x16 tiles

  # one huge isotropic gaussian covering the whole image
  packed = jnp.asarray([[128.0, 128.0, 1.0, 0.0, 200.0, 200.0, 0.9]])
  depth = jnp.asarray([0.5])

  mapping = map_to_tiles(packed, depth, image_size, config,
                         max_overlaps=2048)
  assert int(mapping.num_overflow) == 0
  ranges = np.asarray(mapping.tile_ranges)
  counts = ranges[:, 1] - ranges[:, 0]
  assert np.all(counts == 1), "huge gaussian should cover every tile"
