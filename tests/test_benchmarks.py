"""Benchmark smoke tests (reference tests/test_benchmarks.py:8-22): run each
component bench with tiny sizes so the perf harnesses stay green."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

from benchmarks import bench_components as bc


def test_bench_projection_smoke():
  ms = bc.bench_projection(n=2000, iters=2)
  assert ms > 0


def test_bench_sh_smoke():
  ms = bc.bench_sh(n=2000, degree=2, iters=2)
  assert ms > 0


def test_bench_tilemapper_smoke():
  ms = bc.bench_tilemapper(n=500, image_size=(64, 48), iters=2,
                           max_overlaps=4096)
  assert ms > 0


def test_bench_rasterizer_smoke():
  ms = bc.bench_rasterizer(n=500, image_size=(64, 48), iters=2,
                           max_overlaps=4096)
  assert ms > 0
  ms = bc.bench_rasterizer(n=200, image_size=(32, 32), iters=2,
                           max_overlaps=2048, backward=True)
  assert ms > 0
