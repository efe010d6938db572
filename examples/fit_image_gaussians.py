"""Fit random 2D gaussians to an image — the end-to-end training example.

Port of the reference trainer
(taichi_splatting/examples/fit_image_gaussians.py:31-371):
project2d -> rasterize (visibility + heuristics) -> MSE + opacity/scale
regularisers -> visibility-aware fractional optimizer step with per-point
basis -> parameter clamps, with split/prune between epochs driven by the
prune-cost / split-score heuristics computed in the backward pass.

JAX adaptation: the train step is a pure jitted function over the parameter
dict; heuristics arrive as the gradient of the zero-valued probe input;
split/prune happens between epochs on the host (point counts change shape).

Usage: python examples/fit_image_gaussians.py [image.png]
(no image -> procedural synthetic target, handy without data files)
"""

from __future__ import annotations

import argparse
import math
import time
from functools import partial
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from tpu_splatting import RasterConfig
from tpu_splatting.data_types import Gaussians2D
from tpu_splatting.lib.transforms import inverse_sigmoid
from tpu_splatting.misc.renderer2d import (point_basis,
                                           render_with_heuristics,
                                           uniform_split_gaussians2d)
from tpu_splatting.optim import (GroupConfig, ParameterClass,
                                 VisibilityAwareLaProp)
from tpu_splatting.utils.check_finite import check_finite


def parse_args(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("image_file", type=str, nargs="?", default=None)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--tile_size", type=int, default=16)
  parser.add_argument("--n", type=int, default=1000)
  parser.add_argument("--target", type=int, default=None)
  parser.add_argument("--prune", action="store_true")
  parser.add_argument("--iters", type=int, default=2000)
  parser.add_argument("--max_lr", type=float, default=0.5)
  parser.add_argument("--min_lr", type=float, default=0.1)
  parser.add_argument("--epoch", type=int, default=8)
  parser.add_argument("--max_epoch", type=int, default=32)
  parser.add_argument("--prune_rate", type=float, default=0.025)
  parser.add_argument("--opacity_reg", type=float, default=0.00001)
  parser.add_argument("--scale_reg", type=float, default=0.1)
  parser.add_argument("--antialias", action="store_true")
  parser.add_argument("--max_overlaps", type=int, default=1 << 20)
  parser.add_argument("--image_size", type=str, default="256,192",
                      help="synthetic target size if no image file")
  parser.add_argument("--write_frames", type=Path, default=None)
  parser.add_argument("--profile", action="store_true",
                      help="trace one epoch with jax.profiler")
  parser.add_argument("--profile_dir", type=str,
                      default="traces/fit_image")
  parser.add_argument("--debug", action="store_true",
                      help="check parameters for non-finite values each epoch")
  return parser.parse_args(argv)


def log_lerp(t, a, b):
  return math.exp(math.log(b) * t + math.log(a) * (1 - t))


def psnr(a, b):
  return float(10 * jnp.log10(1.0 / jnp.mean((a - b) ** 2)))


def load_image(args):
  if args.image_file is not None:
    try:
      import cv2
      img = cv2.imread(args.image_file)
      assert img is not None, f"could not read {args.image_file}"
      return jnp.asarray(img.astype(np.float32) / 255.0)
    except ImportError:
      from PIL import Image
      img = np.asarray(Image.open(args.image_file).convert("RGB"))
      return jnp.asarray(img.astype(np.float32) / 255.0)
  # procedural target: smooth color field + shapes
  w, h = map(int, args.image_size.split(","))
  y, x = np.mgrid[0:h, 0:w].astype(np.float32)
  img = np.stack([
      0.5 + 0.5 * np.sin(x / 37.0) * np.cos(y / 23.0),
      0.5 + 0.5 * np.cos((x + y) / 53.0),
      ((x / w) + (y / h)) / 2,
  ], -1)
  cx, cy = w * 0.6, h * 0.4
  circle = ((x - cx) ** 2 + (y - cy) ** 2) < (min(w, h) / 4) ** 2
  img[circle] = np.array([0.9, 0.2, 0.1])
  return jnp.asarray(img)


def random_gaussians2d(key, n, image_size, alpha_range=(0.5, 1.0),
                       scale_factor=0.5, num_channels=3) -> Gaussians2D:
  """jnp port of tests/random_data.py:78-103 (reference fixture)."""
  w, h = image_size
  ks = jax.random.split(key, 6)
  f32 = jnp.float32  # explicit: under x64 test envs random defaults to f64
  position = jax.random.uniform(ks[0], (n, 2), f32) * jnp.asarray(
      [w, h], f32)
  depth = jax.random.uniform(ks[1], (n,), f32)
  density = scale_factor * w / (1 + math.sqrt(n))
  scaling = (jax.random.uniform(ks[2], (n, 2), f32) + 0.2) * density
  rotation = jax.random.normal(ks[3], (n, 2), f32)
  rotation = rotation / jnp.linalg.norm(rotation, axis=1, keepdims=True)
  low, high = alpha_range
  alpha = jax.random.uniform(ks[4], (n,), f32) * (high - low) + low
  return Gaussians2D(
      position=position, depths=depth, log_scaling=jnp.log(scaling),
      rotation=rotation, alpha_logit=inverse_sigmoid(alpha)[:, None],
      feature=jax.random.uniform(ks[5], (n, num_channels), f32))


def make_parameter_groups(max_lr):
  """Reference fit_image_gaussians.py:266-273."""
  return {
      "position": GroupConfig(type="local_vector", lr=max_lr),
      "log_scaling": GroupConfig(type="scalar", lr=0.1),
      "rotation": GroupConfig(type="scalar", lr=1.0),
      "alpha_logit": GroupConfig(type="scalar", lr=0.1),
      "feature": GroupConfig(type="vector", lr=0.025),
  }


def gaussians_from_tensors(tensors) -> Gaussians2D:
  return Gaussians2D(**tensors)


@partial(jax.jit, static_argnames=("optimizer", "config", "image_size",
                                   "max_overlaps", "opacity_reg",
                                   "scale_reg", "position_lr"))
def train_step(tensors, opt_state, ref_image, *, optimizer, config,
               image_size, max_overlaps, opacity_reg, scale_reg,
               position_lr):
  """One optimization step (reference train_epoch body, :103-141)."""
  w, h = image_size

  def loss_fn(out, gaussians):
    scale = jnp.exp(gaussians.log_scaling) / min(w, h)
    return (jnp.mean((out.image - ref_image) ** 2)
            + opacity_reg * jnp.mean(gaussians.opacity)
            + scale_reg * jnp.mean(scale ** 2))

  gaussians = gaussians_from_tensors(tensors)
  loss, out, grads = render_with_heuristics(
      loss_fn, gaussians, image_size, config, max_overlaps)
  grads = {k: getattr(grads, k) for k in tensors}
  heuristics = out.point_heuristic

  basis = point_basis(gaussians)
  opt = optimizer(make_parameter_groups(position_lr),
                  vis_smooth=0.1, vis_beta=0.8)
  new_tensors, opt_state = opt.step(tensors, grads, opt_state,
                                    out.visibility, basis=basis)

  # parameter clamps (reference :138-141)
  rot = new_tensors["rotation"]
  new_tensors["rotation"] = rot / jnp.maximum(
      jnp.linalg.norm(rot, axis=1, keepdims=True), 1e-12)
  new_tensors["log_scaling"] = jnp.clip(new_tensors["log_scaling"], -5, 5)

  return new_tensors, opt_state, loss, out.image, out.visibility, heuristics


def make_epochs(total_iters, first_epoch, max_epoch):
  """Growing epoch sizes (reference :150-165)."""
  iteration, epochs = 0, []
  while iteration < total_iters:
    t = iteration / total_iters
    epoch_size = math.ceil(log_lerp(t, first_epoch, max_epoch))
    if iteration + epoch_size * 2 > total_iters:
      epoch_size = total_iters - iteration
    iteration += epoch_size
    epochs.append(epoch_size)
  return epochs


def take_n(t: np.ndarray, n: int, descending=False) -> np.ndarray:
  order = np.argsort(-t if descending else t)[:n]
  mask = np.zeros(t.shape[0], bool)
  mask[order] = True
  return mask


def find_split_prune(n, target, n_prune, prune_cost, split_score):
  """Reference :190-200."""
  prune_mask = take_n(prune_cost, n_prune, descending=False)
  target_split = max(0, (target - n) + int(prune_mask.sum()))
  split_mask = take_n(split_score, target_split, descending=True)
  both = split_mask & prune_mask
  return split_mask ^ both, prune_mask ^ both


def split_prune(params: ParameterClass, key, t, target, prune_rate,
                heuristics):
  """Reference :202-230: prune lowest prune_cost, split highest split_score."""
  n = params.batch_size[0]
  prune_cost, split_score = heuristics[:, 0], heuristics[:, 1]

  split_mask, prune_mask = find_split_prune(
      n=n, target=target, n_prune=int(prune_rate * n * (1 - t)),
      prune_cost=np.asarray(prune_cost), split_score=np.asarray(split_score))

  to_split = params[jnp.asarray(np.nonzero(split_mask)[0])]
  splits = uniform_split_gaussians2d(
      gaussians_from_tensors(to_split.tensors), key, random_axis=True)

  keep = ~(split_mask | prune_mask)
  params = params[jnp.asarray(np.nonzero(keep)[0])]
  params = params.append_tensors(dict(
      position=splits.position, depths=splits.depths,
      log_scaling=splits.log_scaling, rotation=splits.rotation,
      alpha_logit=splits.alpha_logit, feature=splits.feature))
  return params, dict(split=int(split_mask.sum()), prune=int(prune_mask.sum()))


def main(argv=None):
  args = parse_args(argv)
  key = jax.random.PRNGKey(args.seed)

  ref_image = load_image(args)
  h, w = ref_image.shape[:2]
  image_size = (w, h)
  print(f"Image size: {w}x{h}")

  key, k_init = jax.random.split(key)
  gaussians = random_gaussians2d(k_init, args.n, image_size)

  tensors = dict(position=gaussians.position, depths=gaussians.depths,
                 log_scaling=gaussians.log_scaling,
                 rotation=gaussians.rotation,
                 alpha_logit=gaussians.alpha_logit,
                 feature=gaussians.feature)

  params = ParameterClass.create(
      tensors, make_parameter_groups(args.max_lr),
      optimizer_cls=VisibilityAwareLaProp, vis_smooth=0.1, vis_beta=0.8)

  config = RasterConfig(
      compute_point_heuristic=True, compute_visibility=True,
      tile_size=args.tile_size,
      blur_cov=0.3 if not args.antialias else 0.0,
      antialias=args.antialias)

  lr_range = (args.max_lr, args.min_lr)
  epochs = make_epochs(args.iters, args.epoch, args.max_epoch)
  target = args.n if (args.prune and args.target is None) else args.target

  iteration = 0
  image = None
  t_start = time.time()
  for epoch_i, epoch_size in enumerate(epochs):
    t = (iteration + epoch_size * 0.5) / args.iters
    position_lr = log_lerp(t, *lr_range)

    profiling = args.profile and epoch_i == 1   # second epoch: warm caches
    if profiling:
      jax.profiler.start_trace(args.profile_dir)

    heuristics_sum = jnp.zeros((params.batch_size[0], 2), jnp.float32)
    for _ in range(epoch_size):
      (new_tensors, opt_state, loss, image, visibility,
       heuristics) = train_step(
          params.tensors, params.opt_state, ref_image,
          optimizer=VisibilityAwareLaProp, config=config,
          image_size=image_size, max_overlaps=args.max_overlaps,
          opacity_reg=args.opacity_reg, scale_reg=args.scale_reg,
          position_lr=position_lr)
      params = ParameterClass(new_tensors, params.optimizer, opt_state)
      heuristics_sum = heuristics_sum + heuristics

    if profiling:
      jax.block_until_ready(heuristics_sum)
      jax.profiler.stop_trace()
      print(f"profile trace written to {args.profile_dir}")

    if args.debug:
      check_finite(params.tensors, "params")
      check_finite(heuristics_sum, "heuristics")

    metrics = {
        "CPSNR": f"{psnr(ref_image, image):.2f}",
        "n": params.batch_size[0],
        "loss": f"{float(loss):.5f}",
    }

    if args.write_frames and image is not None:
      args.write_frames.mkdir(exist_ok=True, parents=True)
      frame = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
      try:
        from PIL import Image
        Image.fromarray(frame).save(args.write_frames / f"{iteration:04d}.png")
      except ImportError:
        np.save(args.write_frames / f"{iteration:04d}.npy", frame)

    if target and iteration + epoch_size < args.iters:
      t_points = min((t * 2) ** 0.5, 1.0)
      tgt = math.ceil(params.batch_size[0] * (1 - t_points)
                      + t_points * target)
      key, k_split = jax.random.split(key)
      params, prune_metrics = split_prune(
          params, k_split, t, tgt, args.prune_rate,
          np.asarray(heuristics_sum))
      metrics.update(prune_metrics)

    iteration += epoch_size
    elapsed = time.time() - t_start
    rate = iteration / max(elapsed, 1e-9)
    print(f"iter {iteration:5d}/{args.iters}  {rate:6.1f} it/s  "
          + "  ".join(f"{k}={v}" for k, v in metrics.items()))

  final_psnr = psnr(ref_image, image)
  print(f"final PSNR: {final_psnr:.2f}  points: {params.batch_size[0]}")
  return final_psnr


if __name__ == "__main__":
  main()
