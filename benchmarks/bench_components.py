"""Component micro-benchmarks, mirroring the reference bench defaults
(BASELINE.md §micro-bench: rasterizer/tilemapper n=1e6 @1024x768 tile 16,
projection n=2e6, SH n=1e6 deg 3).  Each function returns ms per call;
``main`` prints them with the device they ran on.

    python -m benchmarks.bench_components --which rasterizer --backward
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import jax
import jax.numpy as jnp

from tpu_splatting import RasterConfig
from tpu_splatting.mapper.tile_mapper import map_to_tiles
from tpu_splatting.perspective.projection import project_gaussians
from tpu_splatting.rasterizer.function import rasterize_with_tiles
from tpu_splatting.spherical_harmonics import evaluate_sh_at
from tpu_splatting.utils.benchmarked import benchmarked


def synthetic_2d(n, image_size, scale_factor=4.0, seed=0):
  rng = np.random.default_rng(seed)
  w, h = image_size
  density = scale_factor * w / (1 + math.sqrt(n))
  packed = np.zeros((n, 7), np.float32)
  packed[:, 0] = rng.uniform(0, w, n)
  packed[:, 1] = rng.uniform(0, h, n)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(theta)
  packed[:, 3] = np.sin(theta)
  packed[:, 4:6] = (rng.random((n, 2)) + 0.2) * density
  packed[:, 6] = rng.uniform(0.1, 0.9, n)
  depth = rng.uniform(0.05, 0.95, n).astype(np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return (jnp.asarray(packed), jnp.asarray(depth), jnp.asarray(feats))


def bench_projection(n=2_000_000, iters=10):
  rng = np.random.default_rng(0)
  z = rng.uniform(1, 50, n)
  args = (
      jnp.asarray(np.stack([rng.uniform(-0.5, 0.5, n) * z,
                            rng.uniform(-0.4, 0.4, n) * z, z], 1),
                  jnp.float32),
      jnp.asarray(rng.normal(-3, 0.5, (n, 3)), jnp.float32),
      jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
      jnp.asarray(rng.normal(0, 1, (n, 1)), jnp.float32),
      jnp.eye(4, dtype=jnp.float32),
      jnp.asarray([1000.0, 1000.0, 512.0, 384.0]),
  )
  f = lambda *a: project_gaussians(*a, (1024, 768), (0.1, 100.0))
  return benchmarked(f, args, iters=iters)


def bench_sh(n=1_000_000, degree=3, iters=10):
  rng = np.random.default_rng(0)
  args = (
      jnp.asarray(rng.standard_normal((n, 3, (degree + 1) ** 2)) * 0.3,
                  jnp.float32),
      jnp.asarray(rng.standard_normal((n, 3)) * 5, jnp.float32),
      jnp.asarray(rng.standard_normal(3), jnp.float32),
  )
  return benchmarked(evaluate_sh_at, args, iters=iters)


def bench_tilemapper(n=1_000_000, image_size=(1024, 768), iters=5,
                     max_overlaps=1 << 22):
  packed, depth, feats = synthetic_2d(n, image_size, scale_factor=2.0)
  config = RasterConfig()
  f = lambda p, d, f_: map_to_tiles(p, d, image_size, config,
                                    max_overlaps=max_overlaps, features=f_)
  return benchmarked(f, (packed, depth, feats), iters=iters)


def bench_rasterizer(n=1_000_000, image_size=(1024, 768), iters=5,
                     max_overlaps=1 << 22, backward=False):
  packed, depth, feats = synthetic_2d(n, image_size)
  config = RasterConfig()
  mapping = jax.jit(lambda p, d, f_: map_to_tiles(
      p, d, image_size, config, max_overlaps=max_overlaps,
      features=f_))(packed, depth, feats)

  if not backward:
    f = lambda p, f_: rasterize_with_tiles(p, f_, mapping, image_size,
                                           config)
    return benchmarked(f, (packed, feats), iters=iters)

  def loss(p, f_):
    o = rasterize_with_tiles(p, f_, mapping, image_size, config)
    return jnp.sum(o.image ** 2) + jnp.sum(o.image_weight)
  return benchmarked(jax.grad(loss, argnums=(0, 1)), (packed, feats),
                     iters=iters)


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--which", default="all",
                      choices=["all", "projection", "sh", "tilemapper",
                               "rasterizer"])
  parser.add_argument("--n", type=int, default=None)
  parser.add_argument("--backward", action="store_true")
  args = parser.parse_args()

  from tpu_splatting.utils.compile_cache import setup_compile_cache
  setup_compile_cache()
  d = jax.devices()[0]
  where = f"{d.platform} {d.device_kind} x{len(jax.devices())}"
  runs = {
      "projection": lambda: bench_projection(args.n or 2_000_000),
      "sh": lambda: bench_sh(args.n or 1_000_000),
      "tilemapper": lambda: bench_tilemapper(args.n or 1_000_000),
      "rasterizer": lambda: bench_rasterizer(args.n or 1_000_000,
                                             backward=args.backward),
  }
  for name, run in runs.items():
    if args.which in ("all", name):
      print(f"{name}: {run():.3f} ms  [{where}]")


if __name__ == "__main__":
  main()
