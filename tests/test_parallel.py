"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_splatting import RasterConfig
from tpu_splatting.optim import GroupConfig
from tpu_splatting.parallel.data_parallel import (data_parallel_loss,
                                                  make_mesh, make_train_step,
                                                  sharded_projection)

from random_data import random_3d_gaussians, random_camera


def make_scene(n_points=256, image_size=(32, 32), seed=0):
  rng = np.random.default_rng(seed)
  camera = random_camera(rng, image_size=image_size)
  gaussians = random_3d_gaussians(rng, n_points, camera)
  gaussians = jax.tree.map(lambda x: x.astype(jnp.float32), gaussians)
  camera = camera.replace(
      projection=camera.projection.astype(jnp.float32),
      T_camera_world=camera.T_camera_world.astype(jnp.float32))
  return gaussians, camera


@pytest.mark.slow
def test_data_parallel_loss_matches_single_device():
  """DP loss == per-camera mean, and the psum'd visibility equals the
  summed single-device visibility."""
  gaussians, camera = make_scene()
  config = RasterConfig(tile_size=16, compute_visibility=True)
  mesh = make_mesh(8)

  rng = np.random.default_rng(1)
  b = 8
  projections = jnp.tile(camera.projection, (b, 1))
  poses = jnp.tile(camera.T_camera_world, (b, 1, 1))
  targets = jnp.asarray(rng.random((b, 32, 32, 3)), jnp.float32)

  loss_fn = data_parallel_loss(mesh, camera, config, max_overlaps=4096)
  shard = NamedSharding(mesh, P("data"))

  sharded, sharded_vis = jax.jit(loss_fn)(
      gaussians, jax.device_put(projections, shard),
      jax.device_put(poses, shard), jax.device_put(targets, shard))

  # single-device reference: mean loss + summed visibility
  from tpu_splatting import render_gaussians

  losses, vis_total = [], 0.0
  for i in range(b):
    cam = camera.replace(projection=projections[i], T_camera_world=poses[i])
    out = render_gaussians(gaussians, cam, config, max_overlaps=4096)
    losses.append(jnp.mean((out.image - targets[i]) ** 2))
    vis_total = vis_total + out.points.visibility
  expected = jnp.mean(jnp.asarray(losses))

  np.testing.assert_allclose(float(sharded), float(expected), rtol=1e-5)
  np.testing.assert_allclose(np.asarray(sharded_vis), np.asarray(vis_total),
                             rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_train_step_runs_and_improves():
  gaussians, camera = make_scene()
  config = RasterConfig(tile_size=16)
  mesh = make_mesh(8)

  groups = {k: GroupConfig(type="scalar", lr=0.05)
            for k in ["position", "log_scaling", "rotation", "alpha_logit"]}
  groups["feature"] = GroupConfig(type="vector", lr=0.05)

  train_step, optimizer = make_train_step(
      mesh, camera, config, groups, max_overlaps=4096)

  tensors = dict(position=gaussians.position,
                 log_scaling=gaussians.log_scaling,
                 rotation=gaussians.rotation,
                 alpha_logit=gaussians.alpha_logit,
                 feature=gaussians.feature)
  opt_state = optimizer.init(tensors)

  rng = np.random.default_rng(2)
  b = 8
  shard = NamedSharding(mesh, P("data"))
  projections = jax.device_put(jnp.tile(camera.projection, (b, 1)), shard)
  poses = jax.device_put(jnp.tile(camera.T_camera_world, (b, 1, 1)), shard)
  targets = jax.device_put(
      jnp.asarray(rng.random((b, 32, 32, 3)) * 0.1, jnp.float32), shard)

  losses = []
  for _ in range(5):
    tensors, opt_state, loss = train_step(tensors, opt_state, projections,
                                          poses, targets)
    losses.append(float(loss))
  assert all(np.isfinite(losses))
  assert losses[-1] < losses[0], f"loss did not improve: {losses}"


@pytest.mark.slow
def test_train_step_matches_single_device_visibility_aware():
  """The DP step (psum'd grads + psum'd per-point visibility) must equal a
  single-device visibility-aware step on the same camera batch."""
  import dataclasses
  from tpu_splatting import Gaussians3D, render_gaussians
  from tpu_splatting.optim import VisibilityAwareLaProp

  gaussians, camera = make_scene()
  config = RasterConfig(tile_size=16)
  mesh = make_mesh(8)

  groups = {k: GroupConfig(type="scalar", lr=0.05)
            for k in ["position", "log_scaling", "rotation", "alpha_logit"]}
  groups["feature"] = GroupConfig(type="vector", lr=0.05)

  train_step, optimizer = make_train_step(
      mesh, camera, config, groups, max_overlaps=4096)

  tensors = dict(position=gaussians.position,
                 log_scaling=gaussians.log_scaling,
                 rotation=gaussians.rotation,
                 alpha_logit=gaussians.alpha_logit,
                 feature=gaussians.feature)
  opt_state = optimizer.init(tensors)

  rng = np.random.default_rng(3)
  b = 8
  shard = NamedSharding(mesh, P("data"))
  projections = jnp.tile(camera.projection, (b, 1))
  poses = jnp.tile(camera.T_camera_world, (b, 1, 1))
  targets = jnp.asarray(rng.random((b, 32, 32, 3)) * 0.1, jnp.float32)

  dp_tensors, _, dp_loss = train_step(
      tensors, opt_state,
      jax.device_put(projections, shard), jax.device_put(poses, shard),
      jax.device_put(targets, shard))

  # single-device reference step
  vis_cfg = dataclasses.replace(config, compute_visibility=True)

  def loss_fn(tensors):
    g = Gaussians3D(**tensors)
    losses, vis = [], 0.0
    for i in range(b):
      cam = camera.replace(projection=projections[i],
                           T_camera_world=poses[i])
      out = render_gaussians(g, cam, vis_cfg, max_overlaps=4096)
      losses.append(jnp.mean((out.image - targets[i]) ** 2))
      vis = vis + out.points.visibility
    return jnp.mean(jnp.asarray(losses)), vis

  (ref_loss, vis), grads = jax.value_and_grad(loss_fn, has_aux=True)(
      tensors)
  ref_opt = VisibilityAwareLaProp(groups)
  ref_tensors, _ = ref_opt.step(tensors, grads, ref_opt.init(tensors), vis)

  np.testing.assert_allclose(float(dp_loss), float(ref_loss), rtol=1e-5)
  for k in tensors:
    np.testing.assert_allclose(np.asarray(dp_tensors[k]),
                               np.asarray(ref_tensors[k]),
                               rtol=1e-4, atol=1e-5, err_msg=k)


def test_sharded_projection_matches_replicated():
  gaussians, camera = make_scene(n_points=256)
  config = RasterConfig()
  mesh = make_mesh(8)

  proj = jax.jit(sharded_projection(mesh, camera, config))
  g_sharded = jax.device_put(gaussians, NamedSharding(mesh, P("data")))
  points, depth, in_view = proj(g_sharded)

  from tpu_splatting.perspective import project_to_image
  exp_points, exp_depth, exp_iv = project_to_image(gaussians, camera, config)

  # loose tolerance: shard_map compiles a different fusion, and the 2x2
  # eigenvector is ill-conditioned near-isotropic, amplifying f32 rounding
  np.testing.assert_allclose(np.asarray(points), np.asarray(exp_points),
                             rtol=1e-3, atol=5e-3)
  np.testing.assert_array_equal(np.asarray(in_view), np.asarray(exp_iv))
