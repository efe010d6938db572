"""Render a 3DGS checkpoint PLY from a chosen viewpoint.

The end-user loop the reference supports through its scripts
(BENCHMARK.md:32-44 renders trained mip-NeRF-360
checkpoints): load a checkpoint, place a camera, render, save the image.

Usage:
  python examples/render_ply.py scene.ply --image_size 1024,768 \
      --camera 0,0,-5 --look_at 0,0,0 --fov 60 --out render.npy

Offline environments without a checkpoint can smoke-test the whole loop
with ``--synthetic N`` (writes a random scene PLY first, exercising
io.ply save+load round-trip).
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np


def look_at_pose(eye, target, up=(0.0, 1.0, 0.0)):
  """World->camera rigid transform (OpenCV convention: +z forward)."""
  eye = np.asarray(eye, np.float32)
  fwd = np.asarray(target, np.float32) - eye
  fwd = fwd / np.linalg.norm(fwd)
  right = np.cross(fwd, np.asarray(up, np.float32))
  right = right / np.linalg.norm(right)
  down = np.cross(fwd, right)
  r = np.stack([right, down, fwd], 0)            # camera rows
  t = -r @ eye
  m = np.eye(4, dtype=np.float32)
  m[:3, :3] = r
  m[:3, 3] = t
  return m


def synthetic_checkpoint(path, n, seed=0):
  import jax.numpy as jnp

  from tpu_splatting import Gaussians3D
  from tpu_splatting.io.ply import save_gaussians

  rng = np.random.default_rng(seed)
  g = Gaussians3D(
      position=jnp.asarray(rng.normal(0.0, 1.2, (n, 3)), jnp.float32),
      log_scaling=jnp.asarray(rng.normal(-3.5, 0.5, (n, 3)), jnp.float32),
      rotation=jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
      alpha_logit=jnp.asarray(rng.normal(0.0, 1.5, (n, 1)), jnp.float32),
      feature=jnp.asarray(rng.normal(0.0, 0.3, (n, 3, 4)), jnp.float32),
  )
  save_gaussians(path, g)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("ply", type=Path)
  p.add_argument("--image_size", default="1024,768")
  p.add_argument("--camera", default="0,0,-5")
  p.add_argument("--look_at", default="0,0,0")
  p.add_argument("--fov", type=float, default=60.0, help="horizontal, deg")
  p.add_argument("--near", type=float, default=0.1)
  p.add_argument("--far", type=float, default=100.0)
  p.add_argument("--depth", action="store_true", help="also render depth")
  p.add_argument("--out", type=Path, default=Path("render.npy"))
  p.add_argument("--synthetic", type=int, default=0,
                 help="write a random N-splat checkpoint to PLY first")
  args = p.parse_args(argv)

  import jax
  import jax.numpy as jnp

  from tpu_splatting import CameraParams, RasterConfig, render_gaussians
  from tpu_splatting.io.ply import load_gaussians

  if args.synthetic:
    synthetic_checkpoint(str(args.ply), args.synthetic)
  gaussians = load_gaussians(str(args.ply))
  n = gaussians.position.shape[0]
  print(f"loaded {n} splats, SH bands {gaussians.feature.shape[-1]}",
        file=sys.stderr)

  w, h = map(int, args.image_size.split(","))
  eye = [float(x) for x in args.camera.split(",")]
  tgt = [float(x) for x in args.look_at.split(",")]
  fx = (w / 2) / math.tan(math.radians(args.fov) / 2)
  camera = CameraParams(
      projection=jnp.asarray([fx, fx, w / 2, h / 2], jnp.float32),
      T_camera_world=jnp.asarray(look_at_pose(eye, tgt)),
      near_plane=args.near, far_plane=args.far, image_size=(w, h))

  config = RasterConfig()
  out = jax.jit(lambda g: render_gaussians(
      g, camera, config, use_sh=True, render_depth=args.depth))(gaussians)
  jax.block_until_ready(out.image)
  overflow = int(out.num_overflow)
  print(f"rendered {w}x{h}: weight mean {float(out.image_weight.mean()):.4f}"
        f", overflow {overflow}", file=sys.stderr)
  if overflow:
    print("WARNING: overlap capacity overflowed — pass a larger"
          " max_overlaps to render_gaussians", file=sys.stderr)

  img = np.clip(np.asarray(out.image), 0.0, 1.0)
  if args.out.suffix == ".npy":
    np.save(args.out, img)
  else:
    try:
      from PIL import Image
      Image.fromarray((img * 255).astype(np.uint8)).save(args.out)
    except ImportError:
      np.save(args.out.with_suffix(".npy"), img)
      print("pillow unavailable — wrote .npy instead", file=sys.stderr)
  if args.depth:
    np.save(args.out.with_suffix(".depth.npy"),
            np.asarray(out.depth_image))
  print(f"wrote {args.out}")
  return float(out.image_weight.mean())


if __name__ == "__main__":
  main()
