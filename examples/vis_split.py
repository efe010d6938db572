"""Visualize gaussian split operations (port of the reference
taichi_splatting/examples/vis_split.py:1-39).

Renders a handful of random 2D gaussians, splits them (uniform axis-aligned
or random-sampled), and renders the result side by side.  Headless-friendly:
writes PNGs (or .npy without pillow) instead of requiring an X display; pass
--show to use cv2 if available.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import sys
from pathlib import Path as _Path
_ROOT = _Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))
sys.path.insert(0, str(_ROOT / "tests"))

import numpy as np
import jax

from tpu_splatting.misc.renderer2d import (render_gaussians,
                                           split_gaussians2d,
                                           uniform_split_gaussians2d)


def save_or_show(name: str, image, out_dir: Path, show: bool):
  frame = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
  if show:
    try:
      import cv2
      cv2.imshow(name, frame)
      while cv2.waitKey(1) == -1:
        pass
      return
    except ImportError:
      pass
  out_dir.mkdir(parents=True, exist_ok=True)
  try:
    from PIL import Image
    Image.fromarray(frame).save(out_dir / f"{name}.png")
  except ImportError:
    np.save(out_dir / f"{name}.npy", frame)
  print(f"wrote {out_dir / name}")


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--n", type=int, default=5)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--uniform", action="store_true",
                      help="axis-aligned split instead of random-sampled")
  parser.add_argument("--out", type=Path, default=Path("traces/vis_split"))
  parser.add_argument("--show", action="store_true")
  args = parser.parse_args(argv)

  from random_data import random_2d_gaussians

  image_size = (640, 480)
  rng = np.random.default_rng(args.seed)
  gaussians = random_2d_gaussians(rng, args.n, image_size, scale_factor=0.2,
                                  alpha_range=(1.0, 1.0))

  out = render_gaussians(gaussians, image_size)
  save_or_show("before_split", out.image, args.out, args.show)

  key = jax.random.PRNGKey(args.seed)
  if args.uniform:
    splits = uniform_split_gaussians2d(gaussians, key, 2, random_axis=True)
  else:
    splits = split_gaussians2d(gaussians, key, 2)

  out = render_gaussians(splits, image_size)
  save_or_show("after_split", out.image, args.out, args.show)


if __name__ == "__main__":
  main()
