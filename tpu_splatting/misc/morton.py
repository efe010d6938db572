"""3D Morton (Z-order) codes and spatial point ordering (pure jnp).

Equivalent of taichi_splatting/misc/morton_sort.py
(:13-152): bit-spreading Morton codes over a bounded grid plus argsort-based
spatial reordering (the reference uses Taichi kernels + the CUB radix
argsort; here the bit-spreads are vectorised integer ops and the sort is
``lax.sort``).

The default is a 30-bit code (32-bit keys sort fastest)
(10 bits per axis, 1024^3 grid); ``morton_codes_60`` returns a (hi, lo) pair
for two-key sorting when finer grids are needed.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _spread_bits_10(x: jnp.ndarray) -> jnp.ndarray:
  """Spread 10 bits of x to every 3rd bit (morton_sort.py:14-22)."""
  x = x.astype(jnp.uint32) & 0x3FF
  x = (x | (x << 16)) & 0x30000FF
  x = (x | (x << 8)) & 0x300F00F
  x = (x | (x << 4)) & 0x30C30C3
  x = (x | (x << 2)) & 0x9249249
  return x


def grid_coords(points: jnp.ndarray, lower: jnp.ndarray, upper: jnp.ndarray,
                bits: int = 10) -> jnp.ndarray:
  """Quantise points into a [0, 2^bits) integer grid (morton_sort Grid)."""
  size = (1 << bits) - 1
  scaled = (points - lower) / jnp.maximum(upper - lower, 1e-12) * size
  return jnp.clip(scaled, 0, size).astype(jnp.uint32)


def morton_codes(points: jnp.ndarray,
                 lower: jnp.ndarray = None,
                 upper: jnp.ndarray = None) -> jnp.ndarray:
  """30-bit Morton codes for (N, 3) points (bounds default to the data)."""
  if lower is None:
    lower = points.min(0)
  if upper is None:
    upper = points.max(0)
  q = grid_coords(points, lower, upper, bits=10)
  code = (_spread_bits_10(q[:, 0])
          | (_spread_bits_10(q[:, 1]) << 1)
          | (_spread_bits_10(q[:, 2]) << 2))
  return code.astype(jnp.int32)


def morton_codes_60(points: jnp.ndarray, lower=None, upper=None
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
  """60-bit codes as an (hi, lo) i32 pair for two-key sorting."""
  if lower is None:
    lower = points.min(0)
  if upper is None:
    upper = points.max(0)
  size = (1 << 20) - 1
  scaled = (points - lower) / jnp.maximum(upper - lower, 1e-12) * size
  q = jnp.clip(scaled, 0, size).astype(jnp.uint32)
  lo = (_spread_bits_10(q[:, 0] & 0x3FF)
        | (_spread_bits_10(q[:, 1] & 0x3FF) << 1)
        | (_spread_bits_10(q[:, 2] & 0x3FF) << 2))
  hi = (_spread_bits_10(q[:, 0] >> 10)
        | (_spread_bits_10(q[:, 1] >> 10) << 1)
        | (_spread_bits_10(q[:, 2] >> 10) << 2))
  return hi.astype(jnp.int32), lo.astype(jnp.int32)


def argsort_morton(points: jnp.ndarray) -> jnp.ndarray:
  """Spatial ordering permutation (morton_sort.py:121-152)."""
  hi, lo = morton_codes_60(points)
  idx = jnp.arange(points.shape[0], dtype=jnp.int32)
  _, _, perm = jax.lax.sort((hi, lo, idx), num_keys=2)
  return perm


def sort_by_morton(points: jnp.ndarray, *arrays):
  """Reorder points (and companion arrays) into Morton order."""
  perm = argsort_morton(points)
  out = tuple(a[perm] for a in (points, *arrays))
  return out if len(out) > 1 else out[0]
