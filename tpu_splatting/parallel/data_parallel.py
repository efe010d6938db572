"""Multi-device parallelism: camera-batch data parallel + point sharding.

The reference is strictly single-GPU/single-process (SURVEY.md §2.9); this
module adds the scale-out axis: a ``jax.sharding.Mesh`` over a flat list of
devices (cards joined all to all, e.g. by NVLink) with

* **camera data parallelism** — a batch of cameras sharded over the mesh,
  gaussians replicated, losses/gradients combined with ``psum`` (NCCL
  all-reduce on GPUs; the natural axis for multi-view splatting training),
  and

* **point sharding** for the embarrassingly-parallel stages (projection /
  SH shading): gaussians sharded over devices, followed by an
  ``all_gather`` before tile mapping.

Everything compiles for any mesh size; tests use virtual CPU devices.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..data_types import Gaussians3D, RasterConfig
from ..optim import GroupConfig, VisibilityAwareLaProp
from ..perspective.params import CameraParams
from ..renderer import render_gaussians


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
  devices = jax.devices()
  if n_devices is not None:
    assert len(devices) >= n_devices, (
        f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
  return Mesh(devices, (axis_name,))


def _render_loss(gaussians: Gaussians3D, projection, t_camera_world,
                 target, camera_template: CameraParams,
                 config: RasterConfig, max_overlaps: int, use_sh: bool):
  camera = camera_template.replace(
      projection=projection, T_camera_world=t_camera_world)
  out = render_gaussians(gaussians, camera, config,
                         max_overlaps=max_overlaps, use_sh=use_sh)
  return jnp.mean((out.image - target) ** 2), out.points.visibility


def data_parallel_loss(mesh: Mesh, camera_template: CameraParams,
                       config: RasterConfig, max_overlaps: int,
                       axis_name: str = "data", use_sh: bool = False):
  """Mean loss + aggregated per-point visibility over a sharded camera batch.

  gaussians: replicated; projections (B, 4), poses (B, 4, 4), targets
  (B, H, W, C): sharded on the batch axis; ``config`` must compute
  visibility.  Returns a callable computing ``(loss, visibility)`` — use
  with ``jax.grad(..., has_aux=True)``; the psums make both the gradients
  and the (N,) visibility (summed over every camera in the global batch)
  replicated.
  """

  def per_shard(gaussians, projections, poses, targets):
    def camera_loss(args):
      proj, pose, target = args
      return _render_loss(gaussians, proj, pose, target, camera_template,
                          config, max_overlaps, use_sh)

    losses, vis = jax.lax.map(camera_loss, (projections, poses, targets))
    total = jax.lax.psum(jnp.sum(losses), axis_name)
    count = jax.lax.psum(losses.shape[0], axis_name)
    vis_total = jax.lax.psum(jnp.sum(vis, 0), axis_name)   # (N,)
    return total / count, vis_total

  return shard_map(
      per_shard, mesh=mesh,
      in_specs=(P(), P(axis_name), P(axis_name), P(axis_name)),
      out_specs=(P(), P()),
      check_vma=False)


def make_train_step(mesh: Mesh, camera_template: CameraParams,
                    config: RasterConfig, parameter_groups: Dict[str,
                                                                 GroupConfig],
                    max_overlaps: int, axis_name: str = "data",
                    use_sh: bool = False):
  """Data-parallel training step: per-camera losses on each device, psum'd
  gradients, visibility-aware update driven by the per-point visibility
  aggregated (psum) across the whole camera batch."""
  import dataclasses
  config = dataclasses.replace(config, compute_visibility=True)
  loss_fn = data_parallel_loss(mesh, camera_template, config, max_overlaps,
                               axis_name, use_sh)
  optimizer = VisibilityAwareLaProp(parameter_groups)

  @jax.jit
  def train_step(tensors: Dict[str, jnp.ndarray], opt_state,
                 projections, poses, targets):
    def wrapped(tensors):
      return loss_fn(Gaussians3D(**tensors), projections, poses, targets)

    (loss, visibility), grads = jax.value_and_grad(
        wrapped, has_aux=True)(tensors)
    new_tensors, new_state = optimizer.step(tensors, grads, opt_state,
                                            visibility)
    return new_tensors, new_state, loss

  return train_step, optimizer


def sharded_projection(mesh: Mesh, camera: CameraParams,
                       config: RasterConfig, axis_name: str = "data"):
  """Point-sharded projection + all_gather: each device projects its
  shard of gaussians, results gathered for the (per-device) rasterizer."""
  from ..perspective.projection import project_to_image

  def per_shard(gaussians: Gaussians3D):
    points, depth, in_view = project_to_image(gaussians, camera, config)
    points = jax.lax.all_gather(points, axis_name, tiled=True)
    depth = jax.lax.all_gather(depth, axis_name, tiled=True)
    in_view = jax.lax.all_gather(in_view, axis_name, tiled=True)
    return points, depth, in_view

  return shard_map(
      per_shard, mesh=mesh,
      in_specs=(P(axis_name),),
      out_specs=(P(), P(), P()),
      check_vma=False)
