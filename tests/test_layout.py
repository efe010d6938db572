"""Data-movement tests against numpy: the kernels' masked load of a tile's
row range (Pallas interpret mode) and the reduction of per-overlap rows to
points — randomized shapes including empty ranges, ranges running off the
end of the rows, and sentinel padding."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from tpu_splatting.rasterizer.kernels import _load_block, reduce_rows_to_points


def _copy_ranges(rows, ranges, block):
  """Each program loads its tile's first ``block`` rows with _load_block."""
  t, width = ranges.shape[0], rows.shape[1]

  def kernel(ranges_ref, rows_ref, out_ref):
    i = pl.program_id(0)
    _, cols = _load_block(rows_ref, ranges_ref[i, 0], ranges_ref[i, 1],
                          width, block)
    for c in range(width):
      out_ref[i, :, c] = cols[c][:, 0]

  return pl.pallas_call(
      kernel, grid=(t,),
      out_shape=jax.ShapeDtypeStruct((t, block, width), rows.dtype),
      interpret=True)(ranges, rows)


@pytest.mark.parametrize("seed", range(4))
def test_window_copy(seed):
  rng = np.random.default_rng(seed)
  g = 8
  p = 256
  k = 17
  rows = rng.standard_normal((p, 5)).astype(np.float32)
  src = rng.integers(0, p, k).astype(np.int32)
  cnt = rng.integers(0, g + 1, k).astype(np.int32)
  cnt[3] = 0
  cnt[5] = g
  src[6] = p - 3                      # range ends at the last row
  cnt[6] = 3
  ranges = np.stack([src, np.minimum(src + cnt, p)], -1).astype(np.int32)

  out = np.asarray(_copy_ranges(jnp.asarray(rows), jnp.asarray(ranges), g))
  expect = np.zeros((k, g, 5), np.float32)
  for i in range(k):
    for r in range(ranges[i, 1] - ranges[i, 0]):
      expect[i, r] = rows[src[i] + r]
  np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [64, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_sorted(seed, n, dtype):
  rng = np.random.default_rng(seed + 10)
  m = 1000
  c = 6
  # ids with gaps, duplicates, and sentinel (>= n) padding rows, in the
  # tile-major order the mapper produces (not sorted by point)
  ids = rng.integers(0, n, m).astype(np.int32)
  ids[-50:] = n + rng.integers(0, 5, 50)
  rows = rng.standard_normal((m, c)).astype(dtype)

  out = np.asarray(reduce_rows_to_points(jnp.asarray(rows), jnp.asarray(ids),
                                         n))

  expect = np.zeros((n, c), dtype)
  for i in range(m):
    if ids[i] < n:
      expect[ids[i]] += rows[i]
  np.testing.assert_allclose(out, expect, rtol=1e-6, atol=1e-6)


def test_segment_sum_sorted_empty_and_heavy():
  """One id owning most rows; many empty ids."""
  m, c, n = 512, 3, 100
  ids = np.full(m, 7, np.int32)
  ids[-10:] = 99
  rows = np.ones((m, c), np.float32)
  out = np.asarray(reduce_rows_to_points(jnp.asarray(rows), jnp.asarray(ids),
                                         n))
  expect = np.zeros((n, c), np.float32)
  expect[7] = m - 10
  expect[99] = 10
  np.testing.assert_allclose(out, expect, rtol=1e-6)
