"""Benchmark timing helper (equivalent of the reference benchmarks/util.py).

The reference times with torch.cuda.Event (benchmarks/util.py:6-44).  Here
the host clock brackets ``iters`` calls of the jitted function, ending in
``block_until_ready`` (JAX returns before the device finishes), after
warm-up calls that compile it.
"""

from __future__ import annotations

import time
from typing import Callable

import jax


def benchmarked(f: Callable, args, iters: int = 10,
                warmup: int = 2) -> float:
  """Milliseconds per call of ``jax.jit(f)(*args)``."""
  fn = jax.jit(f)
  for _ in range(warmup):
    jax.block_until_ready(fn(*args))
  t0 = time.perf_counter()
  for _ in range(iters):
    out = fn(*args)
  jax.block_until_ready(out)
  return (time.perf_counter() - t0) / iters * 1e3
