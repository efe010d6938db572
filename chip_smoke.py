"""Smoke test of the training step on NVIDIA GPUs.

Drives the main path once through the user entry points at the headline
configuration: ``render_with_heuristics`` at 2048x1536 with 2,000,000
seeded splats (``bench.uniform_scene`` + ``lift_to_3d``), SH degree 3,
visibility and prune/split heuristics, gradients on every ``Gaussians3D``
leaf, then a ``VisibilityAwareAdam`` step.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: data-parallel path only

Phases (one card):
  1. device   — JAX's devices and the card's name and power limit
  2. compile  — each raster kernel and the whole step at the real shapes,
                with ``memory_analysis()``
  3. compare  — the compiled step against the plain XLA version, on the
                headline scene and on one whose tiles saturate, and the
                f64 numpy oracle; each tolerance beside its error
  4. train    — three steps: finite loss and gradients, no overflow
  5. time     — step time with each kernel and with its plain version
                (``--trace``: and each variant's stages from a trace)

Every phase prints what it found.  Any failure exits non-zero; the last
line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

IMAGE_SIZE = (2048, 1536)
N = 2_000_000
STEPS = 3


class PhaseError(RuntimeError):
  pass


def check(ok: bool, what: str):
  print(f"  [{'ok' if ok else 'FAIL'}] {what}")
  if not ok:
    raise PhaseError(what)


def card_info() -> str:
  """``nvidia-smi`` name and power limit, from a child that stays off JAX."""
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
  except (OSError, subprocess.TimeoutExpired) as e:
    return f"nvidia-smi unavailable ({e})"
  return (out.stdout or out.stderr).strip()


# ---------------------------------------------------------------------------
# Scene, configuration, step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Setup:
  gaussians: object
  camera: object
  config: object
  target: object          # (T, 3, PIX) tile layout
  mask: object            # (T, 1, PIX) pixels inside the image
  max_overlaps: int
  image_size: tuple


def make_setup(n: int = N, image_size=IMAGE_SIZE, seed: int = 0) -> Setup:
  import jax
  import jax.numpy as jnp

  import bench
  from tpu_splatting import RasterConfig
  from tpu_splatting.mapper.tile_mapper import tile_shape
  from tpu_splatting.rasterizer.function import entile, tile_mask

  packed, depth, feats = bench.uniform_scene(np.random.default_rng(seed), n,
                                             image_size)
  g3d, cam = bench.lift_to_3d(packed, depth, feats, image_size, near=0.1,
                              far=100.0, fov_deg=70.0)
  config = RasterConfig(compute_point_heuristic=True, compute_visibility=True)
  tw, th = tile_shape(image_size, config.tile_size)
  w, h = image_size
  tgt = np.random.default_rng(7).random((h, w, 3)).astype(np.float32)
  target = entile(jnp.asarray(tgt), tw, th, config.tile_size)
  mask = tile_mask(image_size, tw, th, config.tile_size)
  cap = bench.size_overlaps(g3d, cam, config)
  jax.block_until_ready((target, mask))
  return Setup(g3d, cam, config, target, mask, cap, tuple(image_size))


def make_step(s: Setup):
  """One training step: render + loss + backward + VisibilityAwareAdam."""
  import jax
  import jax.numpy as jnp

  from tpu_splatting import Gaussians3D, render_with_heuristics
  from tpu_splatting.optim import GroupConfig, VisibilityAwareAdam

  opt = VisibilityAwareAdam(
      {k: GroupConfig(lr=1e-3) for k in
       ("position", "log_scaling", "rotation", "alpha_logit", "feature")})

  def loss_fn(rendering):
    err = rendering.image - s.target
    return jnp.sum(s.mask * (err * err))

  def step(g, state):
    loss, rendering, grads = render_with_heuristics(
        loss_fn, g, s.camera, s.config, use_sh=True, tiled=True,
        max_overlaps=s.max_overlaps)
    pts = rendering.points
    with jax.named_scope("optimizer"):
      params, state = opt.step(dataclasses.asdict(g),
                               dataclasses.asdict(grads), state,
                               pts.visibility)
    aux = dict(loss=loss, grads=grads, visibility=pts.visibility,
               prune_cost=pts.prune_cost, split_score=pts.split_score,
               image=rendering.image, image_weight=rendering.image_weight,
               num_overflow=rendering.num_overflow)
    return Gaussians3D(**params), state, aux

  return step, opt.init(dataclasses.asdict(s.gaussians))


def jit_step(s: Setup, forward: str = "pallas", backward: str = "pallas"):
  """The jitted step, traced with the given raster implementations."""
  import jax

  from tpu_splatting.rasterizer.function import raster_impl

  step, state = make_step(s)
  with raster_impl(forward, backward):
    lowered = jax.jit(step).lower(s.gaussians, state)
  return lowered.compile(), state


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device(platform: str = "gpu"):
  import jax

  devs = jax.devices()
  d = devs[0]
  print(f"  jax {jax.__version__}: {len(devs)} x {d.platform} "
        f"({d.device_kind})")
  print(f"  card: {card_info()}")
  check(d.platform == platform, f"platform is {platform}")
  return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def phase_compile(s: Setup):
  import jax

  from tpu_splatting.rasterizer import kernels

  _, _, m = project_and_map(s)
  rows = m.sorted_payload
  t = m.num_tiles
  print(f"  overlaps {int(m.tile_ranges[-1, 1])} of capacity "
        f"{rows.shape[0]}, {t} tiles, max per tile "
        f"{int((m.tile_ranges[:, 1] - m.tile_ranges[:, 0]).max())}")
  f = rows.shape[1] - 7
  img = jax.ShapeDtypeStruct((t, f + 1, s.config.tile_area), rows.dtype)
  fwd = jax.jit(lambda r, tr: kernels.forward(r, tr, s.config, m.tiles_wide))
  bwd = jax.jit(lambda r, tr, o, i, g: kernels.backward(
      r, tr, o, i, g, s.config, m.tiles_wide, m.num_points))
  for name, fn, args in [
      ("raster_forward", fwd, (rows, m.tile_ranges)),
      ("raster_backward", bwd, (rows, m.tile_ranges, m.overlap_to_point,
                                img, img))]:
    t0 = time.perf_counter()
    fn.lower(*args).compile()
    print(f"  compiled {name} in {time.perf_counter() - t0:.1f} s")
  t0 = time.perf_counter()
  compiled, state = jit_step(s)
  print(f"  compiled the step in {time.perf_counter() - t0:.1f} s")
  print(f"  step memory_analysis: {compiled.memory_analysis()}")
  return compiled, state


def project_and_map(s: Setup):
  """The step's projection, SH colours and tile mapping."""
  import jax
  import jax.numpy as jnp

  from tpu_splatting.mapper.tile_mapper import map_to_tiles
  from tpu_splatting.perspective.projection import ndc_depth, project_to_image
  from tpu_splatting.spherical_harmonics import evaluate_sh_at

  @jax.jit
  def run(g):
    g2d, depths, _ = project_to_image(g, s.camera, s.config)
    feats = evaluate_sh_at(g.feature, g.position, s.camera.camera_position)
    nd = jnp.where(depths > 0, ndc_depth(depths, s.camera.near_plane,
                                         s.camera.far_plane), 0.0)
    m = map_to_tiles(g2d, nd, s.image_size, s.config,
                     max_overlaps=s.max_overlaps, features=feats)
    return g2d, feats, m

  return run(s.gaussians)


def _rel_l2(a, b):
  a = np.asarray(a, np.float64)
  b = np.asarray(b, np.float64)
  return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def saturating(s: Setup, k: int = 32, sigma_px: float = 24.0):
  """The scene with its first ``k`` splats made into a stack of large,
  nearly opaque splats in front of the image centre: the tiles under the
  stack saturate after its rows, well before their last row, while the
  overlaps grow by only ``k`` splats' footprints."""
  import jax.numpy as jnp

  g = {n: np.array(v) for n, v in dataclasses.asdict(s.gaussians).items()}
  fx = float(np.asarray(s.camera.projection)[0])
  z = 1.0 + 0.01 * np.arange(k, dtype=np.float32)
  g["position"][:k] = np.stack([0 * z, 0 * z, z], -1)
  g["log_scaling"][:k] = np.log(sigma_px * z / fx)[:, None]
  g["rotation"][:k] = [0.0, 0.0, 0.0, 1.0]
  g["alpha_logit"][:k] = 7.0
  return type(s.gaussians)(**{n: jnp.asarray(v) for n, v in g.items()})


def compare_outputs(s: Setup, out_k: dict, out_p: dict):
  """§3 tolerances of the Pallas step's outputs against the plain step's."""
  # forward: image + alpha; the two sum a few hundred terms per pixel in
  # different orders (~1e-6 each); a splat whose alpha sits within rounding
  # of alpha_threshold may flip and move one pixel by up to ~1e-2
  inside = np.asarray(s.mask)[:, 0, :] > 0
  err = np.concatenate([
      np.abs(out_k["image"] - out_p["image"]).transpose(0, 2, 1)[inside],
      np.abs(out_k["image_weight"] - out_p["image_weight"])[inside][:, None]],
      -1).max(-1)
  p999 = float(np.quantile(err, 0.999))
  flips = int((err > 1e-3).sum())
  print(f"  forward vs plain: p99.9 {p999:.3g}, max {err.max():.3g}, "
        f"pixels > 1e-3: {flips} of {err.size}")
  check(p999 <= 1e-4, "forward p99.9 abs error <= 1e-4")
  check(err.max() <= 1e-2, "forward max abs error <= 1e-2")
  check(flips <= 1e-5 * err.size, "pixels off by > 1e-3 <= 1e-5 of all")

  # backward: sums in other orders change the last bits
  pairs = {f"grad {k}": (out_k["grads"].__dict__[k],
                         out_p["grads"].__dict__[k])
           for k in ("position", "log_scaling", "rotation", "alpha_logit",
                     "feature")}
  for k in ("visibility", "prune_cost", "split_score"):
    pairs[k] = (out_k[k], out_p[k])
  for name, (a, b) in pairs.items():
    e = _rel_l2(a, b)
    print(f"  {name}: rel L2 {e:.3g}")
    check(np.isfinite(np.asarray(a)).all(), f"{name} finite")
    check(e <= 1e-3, f"{name} rel L2 <= 1e-3")


def phase_compare(s: Setup, compiled, state, num_oracle_tiles: int = 16):
  """The compiled step that trains and is timed, against the plain XLA
  version (traced at HIGHEST matmul precision) on the headline scene and
  a saturating one, and against the f64 oracle on sampled tiles."""
  import jax

  from tpu_splatting.rasterizer.reference import rasterize_reference

  # the plain reference in f32 throughout: none of its dots falls to TF32
  with jax.default_matmul_precision("highest"):
    plain, _ = jit_step(s, "plain", "plain")
  scenes = {"headline": s.gaussians, "saturating": saturating(s)}
  for name, g in scenes.items():
    out_k = jax.device_get(compiled(g, state)[2])
    out_p = jax.device_get(plain(g, state)[2])
    weight = np.asarray(out_p["image_weight"])
    full = int((weight >= s.config.saturate_threshold - 1e-6).all(-1).sum())
    print(f"  {name} scene: {full} of {weight.shape[0]} tiles saturated, "
          f"overflow {int(out_k['num_overflow'])}")
    check(int(out_k["num_overflow"]) == 0, f"{name}: num_overflow == 0")
    if name == "saturating":
      check(full > 0, "saturating scene saturates tiles")
    compare_outputs(s, out_k, out_p)
    if name == "headline":
      headline = out_k

  # oracle: numpy f64, sequential per point, on sampled non-empty tiles
  g2d, feats, m = jax.device_get(project_and_map(s))
  counts = m.tile_ranges[:, 1] - m.tile_ranges[:, 0]
  rng = np.random.default_rng(11)
  tiles = rng.choice(np.nonzero(counts)[0],
                     min(num_oracle_tiles, int((counts > 0).sum())),
                     replace=False)
  ref_img, ref_alpha, _ = rasterize_reference(g2d, feats, m, s.image_size,
                                              s.config, tiles=tiles)
  got = np.concatenate([headline["image"][tiles].transpose(0, 2, 1),
                        headline["image_weight"][tiles][..., None]], -1)
  ref = np.concatenate([ref_img, ref_alpha[..., None]], -1)
  e = float(np.abs(got - ref).max())
  print(f"  oracle on {len(tiles)} tiles ({int(counts[tiles].sum())} "
        f"overlaps): max abs error {e:.3g}")
  check(e <= 1e-4, "image vs f64 oracle abs error <= 1e-4")


def phase_train(s: Setup, compiled, state, steps: int = STEPS):
  import jax

  g = s.gaussians
  for i in range(steps):
    g, state, aux = compiled(g, state)
    aux = jax.device_get(aux)
    grads_ok = all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(aux["grads"]))
    print(f"  step {i}: loss {float(aux['loss']):.6g}, overflow "
          f"{int(aux['num_overflow'])}, grads finite {grads_ok}")
    check(np.isfinite(aux["loss"]), "loss finite")
    check(grads_ok, "every gradient finite")
    check(int(aux["num_overflow"]) == 0, "num_overflow == 0")
  leaves = jax.tree.leaves(g)
  check(all(np.isfinite(np.asarray(x)).all() for x in leaves),
        "updated splats finite")


def time_steps(variants: dict, g, state, iters: int = 5, rounds: int = 2):
  """Host clock around ``block_until_ready``, variants in turns after a
  warm-up; returns the median ms per step of each variant."""
  import jax

  times = {k: [] for k in variants}
  for fn in variants.values():
    jax.block_until_ready(fn(g, state))
  for _ in range(rounds):
    for name, fn in variants.items():
      t0 = time.perf_counter()
      for _ in range(iters):
        out = fn(g, state)
      jax.block_until_ready(out)
      times[name].append((time.perf_counter() - t0) / iters * 1e3)
  return {k: float(np.median(v)) for k, v in times.items()}


def phase_time(s: Setup, compiled, state, iters: int = 5,
               trace: bool = False):
  variants = {"pallas fwd + pallas bwd": compiled}
  for fwd, bwd in (("plain", "pallas"), ("pallas", "plain")):
    variants[f"{fwd} fwd + {bwd} bwd"] = jit_step(s, fwd, bwd)[0]
  ms = time_steps(variants, s.gaussians, state, iters=iters)
  card = card_info()
  for name, t in ms.items():
    print(f"  step {name}: {t:.3f} ms  [{card}]")
  if trace:
    variants["plain fwd + plain bwd"] = jit_step(s, "plain", "plain")[0]
    for i, (name, fn) in enumerate(variants.items()):
      stages = stage_times(f"step{i}", fn, state, s.gaussians)
      total = sum(stages.values())
      print(f"  trace {name}: device {total:.3f} ms/step  [{card}]")
      for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"    {k}: {v:.3f} ms ({v / total * 100:.1f}%)")
  return ms


STAGES = ("optimizer", "raster_backward", "raster_forward", "map_to_tiles",
          "sh", "project")


def stage_times(name: str, compiled, state, g, steps: int = 2) -> dict:
  """Device ms per step of each named stage, from a profiler trace of
  ``steps`` steps written under ``traces/``: GPU kernel events are matched
  to their HLO instructions' op_name scopes (Pallas kernels by name)."""
  import jax

  def norm(n):
    return re.sub(r"__\d+$", "", re.sub(r"[.\-]", "_", n))

  op_name = {}
  for line in compiled.as_text().splitlines():
    m = re.match(r'\s*(?:ROOT )?%?([\w.\-]+) = .*op_name="([^"]*)"', line)
    if m:
      op_name[norm(m.group(1))] = m.group(2)
  jax.block_until_ready(compiled(g, state))
  out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "traces", name)
  jax.profiler.start_trace(out_dir)
  for _ in range(steps):
    jax.block_until_ready(compiled(g, state))
  jax.profiler.stop_trace()
  path = sorted(glob.glob(f"{out_dir}/plugins/profile/*/*.xplane.pb"))[-1]
  ms = collections.Counter()
  for plane in jax.profiler.ProfileData.from_file(path).planes:
    if "/device:GPU" not in plane.name:
      continue
    for line in plane.lines:
      for ev in line.events:
        scope = ev.name if ev.name.startswith("raster_") else op_name.get(
            norm(ev.name), "")
        stage = next((k for k in STAGES if re.search(
            r"(^|/|\()" + k + r"(/|\)|$|_)", scope)), "other")
        ms[stage] += ev.duration_ns / 1e6 / steps
  return dict(ms)


# ---------------------------------------------------------------------------
# Four cards: camera-batch data parallelism
# ---------------------------------------------------------------------------


def four_card_cameras(cam, b: int):
  """``b`` seeded camera poses around the headline camera."""
  import jax.numpy as jnp

  rng = np.random.default_rng(5)
  poses = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
  poses[:, :3, 3] = rng.normal(0.0, 0.05, (b, 3))
  return (jnp.tile(cam.projection, (b, 1)), jnp.asarray(poses))


def phase_data_parallel(s: Setup, devices: int = 4):
  """make_train_step over a ``devices``-card mesh against the same camera
  batch on one card (lax.map), plus point-sharded projection."""
  import jax
  import jax.numpy as jnp
  from jax.sharding import NamedSharding, PartitionSpec as P

  from tpu_splatting import Gaussians3D, render_gaussians
  from tpu_splatting.optim import GroupConfig, VisibilityAwareLaProp
  from tpu_splatting.parallel.data_parallel import (make_mesh,
                                                    make_train_step,
                                                    sharded_projection)
  from tpu_splatting.perspective import project_to_image

  mesh = make_mesh(devices)
  groups = {k: GroupConfig(lr=1e-3) for k in
            ("position", "log_scaling", "rotation", "alpha_logit", "feature")}
  cfg = dataclasses.replace(s.config, compute_point_heuristic=False)
  train_step, opt = make_train_step(mesh, s.camera, cfg, groups,
                                    s.max_overlaps, use_sh=True)
  tensors = dataclasses.asdict(s.gaussians)
  state = opt.init(tensors)
  projections, poses = four_card_cameras(s.camera, devices)
  w, h = s.image_size
  targets = jnp.asarray(np.random.default_rng(9).random(
      (devices, h, w, 3)).astype(np.float32))
  shard = NamedSharding(mesh, P("data"))
  t0 = time.perf_counter()
  dp_tensors, _, dp_loss = train_step(
      tensors, state, jax.device_put(projections, shard),
      jax.device_put(poses, shard), jax.device_put(targets, shard))
  jax.block_until_ready(dp_tensors)
  print(f"  {devices}-card step (compile included): "
        f"{time.perf_counter() - t0:.1f} s, loss {float(dp_loss):.6g}")

  # the same camera batch on one card, cameras in sequence
  vis_cfg = dataclasses.replace(cfg, compute_visibility=True)
  dev0 = jax.devices()[0]

  @jax.jit
  def single(tensors, projections, poses, targets):
    def loss_fn(tensors):
      g = Gaussians3D(**tensors)

      def one(args):
        proj, pose, target = args
        out = render_gaussians(
            g, s.camera.replace(projection=proj, T_camera_world=pose),
            vis_cfg, max_overlaps=s.max_overlaps, use_sh=True)
        return jnp.mean((out.image - target) ** 2), out.points.visibility

      losses, vis = jax.lax.map(one, (projections, poses, targets))
      return jnp.mean(losses), jnp.sum(vis, 0)

    (loss, vis), grads = jax.value_and_grad(loss_fn, has_aux=True)(tensors)
    ref_opt = VisibilityAwareLaProp(groups)
    new, _ = ref_opt.step(tensors, grads, ref_opt.init(tensors), vis)
    return new, loss

  put = lambda x: jax.device_put(x, dev0)
  ref_tensors, ref_loss = single(put(tensors), put(projections), put(poses),
                                 put(targets))
  e = abs(float(dp_loss) - float(ref_loss)) / abs(float(ref_loss))
  print(f"  loss vs one card: rel error {e:.3g}")
  check(e <= 1e-4, "data-parallel loss rel error <= 1e-4")
  for k in tensors:
    e = _rel_l2(dp_tensors[k], ref_tensors[k])
    print(f"  updated {k}: rel L2 {e:.3g}")
    check(e <= 1e-4, f"updated {k} rel error <= 1e-4")

  proj = jax.jit(sharded_projection(mesh, s.camera, cfg))
  pts, depth, in_view = proj(jax.device_put(s.gaussians, shard))
  ref_pts, ref_depth, ref_iv = jax.jit(
      lambda g: project_to_image(g, s.camera, cfg))(put(s.gaussians))
  e = _rel_l2(pts, ref_pts)
  print(f"  sharded projection vs one card: rel L2 {e:.3g}")
  check(e <= 1e-4, "sharded projection rel error <= 1e-4")
  check(bool((np.asarray(in_view) == np.asarray(ref_iv)).all()),
        "sharded projection in_view identical")


# ---------------------------------------------------------------------------


def run(chips: int = 1, n: int = N, image_size=IMAGE_SIZE,
        platform: str = "gpu", steps: int = STEPS, iters: int = 5,
        trace: bool = False) -> dict:
  """All phases at the given sizes; returns the device summary."""
  from tpu_splatting.utils.compile_cache import setup_compile_cache

  setup_compile_cache()
  print("phase 1: device")
  device = phase_device(platform)
  if chips > 1:
    check(device["count"] >= chips, f"{chips} devices present")
    s = make_setup(n, image_size)
    print(f"phase: data parallel over {chips} cards")
    phase_data_parallel(s, chips)
    return dict(device, count=chips)
  s = make_setup(n, image_size)
  print(f"  scene: {n} splats at {image_size[0]}x{image_size[1]}, "
        f"max_overlaps {s.max_overlaps}")
  print("phase 2: compile")
  compiled, state = phase_compile(s)
  print("phase 3: compare")
  phase_compare(s, compiled, state)
  print("phase 4: train")
  phase_train(s, compiled, state, steps)
  print("phase 5: time")
  phase_time(s, compiled, state, iters, trace)
  return device


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--chips", type=int, default=1, choices=(1, 4))
  parser.add_argument("--trace", action="store_true",
                      help="also split each step variant into stages from "
                      "a profiler trace (written under traces/)")
  args = parser.parse_args()
  try:
    device = run(chips=args.chips, trace=args.trace)
  except PhaseError as e:
    print(f"FAILED: {e}", file=sys.stderr)
    sys.exit(1)
  print(f"card: {card_info()}")
  print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
  main()
