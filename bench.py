"""Headline benchmark: one training render on one GPU, as one JSON line.

Protocol (BASELINE.md): forward + backward render at 2048 px, against the
reference's RTX 4090 numbers (diff_gaussian_rasterization 35.1 ms/frame on
the bicycle scene).  The mip-NeRF-360 scenes are not available offline, so
seeded synthetic scenes stand in:

* ``uniform``: 2M small uniform splats at 2048x1536 with a bicycle-like
  overlap/pixel profile.
* ``heavy``: log-normal splat scales + near-1 alpha mass modelled on 3DGS
  checkpoint statistics (a long scale tail, splats spanning many tiles);
  not timed yet.

The timed frame is the full renderer on the uniform scene, as the
reference times ``render_gaussians`` end to end (BENCHMARK.md:32-44):
3D projection + SH degree 3 + tile mapping + rasterize forward and
backward with visibility and point heuristics, gradients on every
Gaussians3D leaf, in one jit.  It is timed with the host clock around
``block_until_ready`` and is only reported when the mapping drops no
overlap (num_overflow == 0).

Prints one line naming the device:
  {"metric": "synthetic_bicycle_2048px_fwd_bwd", "value": <ms>, "unit": "ms",
   "vs_baseline": 35.1 / value, "device": {...}}
Any error exits non-zero.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np

BASELINE_MS = 35.1  # diff_gaussian_rasterization, bicycle @ 2048, RTX 4090
IMAGE_SIZE = (2048, 1536)
N = 2_000_000


def uniform_scene(rng, n, image_size):
  w, h = image_size
  density = 1.2 * w / (1 + math.sqrt(n))
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
  return packed, depth, feats


def heavy_scene(rng, n, image_size):
  """3DGS-checkpoint-like statistics: log-normal projected scales (median
  ~1.3 px, long tail to ~100 px), anisotropy, opacity mass near 0 and 1
  (sigmoid of a wide logit distribution), mild spatial clustering."""
  w, h = image_size
  packed = np.zeros((n, 7), np.float32)
  # cluster centres + jitter: non-uniform tile occupancy like real scenes
  n_c = 4096
  centres = np.stack([rng.uniform(0, w, n_c), rng.uniform(0, h, n_c)], 1)
  which = rng.integers(0, n_c, n)
  jitter = rng.normal(0.0, 0.08, (n, 2)) * np.asarray([w, h])
  pos = centres[which] + jitter
  packed[:, 0] = np.clip(pos[:, 0], 0, w - 1)
  packed[:, 1] = np.clip(pos[:, 1], 0, h - 1)
  theta = rng.uniform(0, np.pi, n)
  packed[:, 2] = np.cos(theta)
  packed[:, 3] = np.sin(theta)
  s_major = np.exp(rng.normal(0.35, 0.9, n)).astype(np.float32)   # px
  ratio = np.exp(-np.abs(rng.normal(0.0, 0.7, n))).astype(np.float32)
  packed[:, 4] = np.clip(s_major, 0.05, 110.0)
  packed[:, 5] = np.clip(s_major * ratio, 0.05, 110.0)
  packed[:, 6] = 1.0 / (1.0 + np.exp(-rng.normal(0.0, 2.5, n)))
  depth = rng.uniform(0.02, 0.98, n).astype(np.float32)
  feats = rng.random((n, 3)).astype(np.float32)
  return packed, depth.astype(np.float32), feats


def lift_to_3d(packed, depth_ndc, feats, image_size, near, far, fov_deg):
  """Lift a 2D bench scene to Gaussians3D + CameraParams whose projection
  reproduces (approximately) the same screen-space statistics: each splat
  sits on the camera ray through its 2D position at a metric depth mapped
  from the scene's NDC depth, with in-plane 3D scales = pixel scales
  * z / f and orientation = in-plane rotation about the view axis."""
  import jax.numpy as jnp

  from tpu_splatting import Gaussians3D
  from tpu_splatting.perspective.params import CameraParams

  w, h = image_size
  fx = fy = 0.5 * w / math.tan(0.5 * math.radians(fov_deg))
  cx, cy = w / 2.0, h / 2.0

  # invert ndc_depth's mapping (perspective/projection.py): ndc linear in
  # 1/z between near and far
  z = 1.0 / (1.0 / near + depth_ndc * (1.0 / far - 1.0 / near))
  x3 = (packed[:, 0] - cx) * z / fx
  y3 = (packed[:, 1] - cy) * z / fy

  s_px = packed[:, 4:6]
  s3 = s_px * (z / fx)[:, None]
  log_scaling = np.log(np.concatenate(
      [s3, np.minimum(s3[:, :1], s3[:, 1:])], -1).astype(np.float32))

  # in-plane rotation about the view (z) axis, xyzw quaternion
  theta = np.arctan2(packed[:, 3], packed[:, 2])
  quat = np.zeros((packed.shape[0], 4), np.float32)
  quat[:, 2] = np.sin(0.5 * theta)
  quat[:, 3] = np.cos(0.5 * theta)

  a = np.clip(packed[:, 6], 1e-4, 1 - 1e-4)
  alpha_logit = np.log(a / (1 - a)).astype(np.float32)[:, None]

  # SH degree 3: DC carries the colour, small random higher-order terms
  n = packed.shape[0]
  sh = np.zeros((n, 3, 16), np.float32)
  sh[:, :, 0] = feats / 0.28209479177387814
  sh[:, :, 1:] = np.random.default_rng(3).normal(
      0.0, 0.02, (n, 3, 15)).astype(np.float32)

  g3d = Gaussians3D(
      position=jnp.asarray(np.stack([x3, y3, z], -1).astype(np.float32)),
      log_scaling=jnp.asarray(log_scaling),
      rotation=jnp.asarray(quat),
      alpha_logit=jnp.asarray(alpha_logit),
      feature=jnp.asarray(sh))
  cam = CameraParams(
      projection=jnp.asarray([fx, fy, cx, cy], jnp.float32),
      T_camera_world=jnp.eye(4, dtype=jnp.float32),
      near_plane=near, far_plane=far, image_size=image_size)
  return g3d, cam


def size_overlaps(gaussians, camera, config, headroom: float = 1.1) -> int:
  """Static overlap capacity for a scene: the overlaps one mapping of the
  projected splats finds, plus headroom."""
  import jax
  import jax.numpy as jnp

  from tpu_splatting.mapper.tile_mapper import map_to_tiles
  from tpu_splatting.perspective.projection import ndc_depth, project_to_image

  @jax.jit
  def count(g):
    g2d, depths, _ = project_to_image(g, camera, config)
    nd = jnp.where(depths > 0, ndc_depth(depths, camera.near_plane,
                                         camera.far_plane), 0.0)
    m = map_to_tiles(g2d, nd, camera.image_size, config)
    return m.tile_ranges[-1, 1], m.num_overflow

  total, overflow = jax.device_get(count(gaussians))
  assert int(overflow) == 0, (
      f"default overlap capacity overflowed by {int(overflow)}")
  return int(int(total) * headroom) + 1024


def device_summary() -> dict:
  """The device as JAX reports it, plus the card's name and power limit
  (from nvidia-smi in a child process that stays off JAX)."""
  import jax

  devs = jax.devices()
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True)
  return {"platform": devs[0].platform, "kind": devs[0].device_kind,
          "count": len(devs), "card": out.stdout.strip().splitlines()[0]}


def bench_full_renderer(name, packed, depth, feats):
  """The complete renderer — projection, SH degree 3, tile mapping,
  rasterize fwd+bwd with heuristics — as one jit, gradients w.r.t. every
  Gaussians3D leaf."""
  import jax
  import jax.numpy as jnp

  from tpu_splatting import RasterConfig
  from tpu_splatting.mapper.tile_mapper import tile_shape
  from tpu_splatting.rasterizer.function import entile, tile_mask
  from tpu_splatting.renderer import render_with_heuristics
  from tpu_splatting.utils.benchmarked import benchmarked

  config = RasterConfig(compute_point_heuristic=True, compute_visibility=True)
  g3d, cam = lift_to_3d(packed, depth, feats, IMAGE_SIZE,
                        near=0.1, far=100.0, fov_deg=70.0)
  cap = size_overlaps(g3d, cam, config)

  # tiled-layout loss: the target entiles once outside the step, so the
  # step never leaves tile layout
  tw, th = tile_shape(IMAGE_SIZE, config.tile_size)
  rngt = np.random.default_rng(7)
  tgt = entile(jnp.asarray(
      rngt.random((IMAGE_SIZE[1], IMAGE_SIZE[0], 3)).astype(np.float32)),
      tw, th, config.tile_size)
  mask = tile_mask(IMAGE_SIZE, tw, th, config.tile_size)

  def loss_fn(rendering):
    err = rendering.image - tgt                  # (T, 3, PIX)
    return jnp.sum(mask * (err * err))

  def step(g):
    loss, rendering, grads = render_with_heuristics(
        loss_fn, g, cam, config, use_sh=True, tiled=True, max_overlaps=cap)
    return loss, grads, rendering.num_overflow

  overflow = int(jax.jit(step)(g3d)[2])
  assert overflow == 0, f"{name}: benchmark invalid, {overflow} rows dropped"
  ms = benchmarked(step, (g3d,), iters=5)
  return {f"{name}_full_ms": ms, f"{name}_max_overlaps": cap}


def main():
  from tpu_splatting.utils.compile_cache import setup_compile_cache

  setup_compile_cache()
  device = device_summary()
  if device["platform"] != "gpu":
    sys.exit(f"bench.py measures a GPU; JAX found {device['platform']}")
  print(f"# device {json.dumps(device)}", file=sys.stderr)

  p, d, f = uniform_scene(np.random.default_rng(0), N, IMAGE_SIZE)
  out = {"metric": "synthetic_bicycle_2048px_fwd_bwd", "unit": "ms"}
  out.update(bench_full_renderer("uniform", p, d, f))
  ms = out["uniform_full_ms"]
  out["value"] = ms
  out["vs_baseline"] = BASELINE_MS / ms
  out["device"] = device
  print(json.dumps(out))


if __name__ == "__main__":
  main()
