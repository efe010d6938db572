"""End-to-end renderer tests: 3D scene -> image, jit, gradients, depth
outputs, SH path (mirrors the composition in reference renderer.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_splatting import RasterConfig, render_gaussians

from random_data import random_3d_gaussians, random_camera


def small_cfg(**kw):
  return RasterConfig(tile_size=16, **kw)


def make_scene(seed, n=100, image_size=(64, 48)):
  rng = np.random.default_rng(seed)
  camera = random_camera(rng, image_size=image_size)
  gaussians = random_3d_gaussians(rng, n, camera, scale_factor=1.0)
  return gaussians, camera


@pytest.mark.parametrize(
    "seed", [0, *(pytest.param(s, marks=pytest.mark.slow)
                  for s in range(1, 3))])
def test_render_gaussians_end_to_end(seed):
  gaussians, camera = make_scene(seed)
  config = small_cfg(compute_visibility=True)

  render = jax.jit(lambda g: render_gaussians(
      g, camera, config, max_overlaps=8192))

  out = render(gaussians)
  h, w = camera.image_size[1], camera.image_size[0]
  assert out.image.shape == (h, w, 3)
  assert out.image_weight.shape == (h, w)
  assert bool(jnp.isfinite(out.image).all())
  assert float(out.image_weight.min()) >= 0
  assert float(out.image.max()) > 0, "something should render"
  assert bool(out.points.in_view.any())
  assert int(out.num_overflow) == 0


@pytest.mark.slow
def test_render_with_sh():
  gaussians, camera = make_scene(1)
  # degree-2 SH coefficients
  rng = np.random.default_rng(5)
  sh_feats = jnp.asarray(rng.standard_normal((100, 3, 9)) * 0.2, jnp.float32)
  gaussians = gaussians.replace(feature=sh_feats)
  config = small_cfg()

  out = jax.jit(lambda g: render_gaussians(
      g, camera, config, use_sh=True, max_overlaps=8192))(gaussians)
  assert out.image.shape[-1] == 3
  assert bool(jnp.isfinite(out.image).all())


def test_render_depth_outputs():
  gaussians, camera = make_scene(2)
  config = small_cfg()

  out = jax.jit(lambda g: render_gaussians(
      g, camera, config, render_depth=True, render_median_depth=True,
      max_overlaps=8192))(gaussians)

  h, w = camera.image_size[1], camera.image_size[0]
  assert out.depth_image.shape == (h, w)
  assert out.median_depth_image.shape == (h, w)
  assert bool(jnp.isfinite(out.depth_image).all())

  # depth values must lie in the scene's depth range where alpha is solid
  solid = np.asarray(out.image_weight) > 0.5
  if solid.any():
    d = np.asarray(out.depth_image)[solid]
    assert d.min() > 0
    md = np.asarray(out.median_depth_image)[solid]
    assert (md > 0).mean() > 0.9


def test_render_gradients_flow_to_all_inputs():
  gaussians, camera = make_scene(3)
  config = small_cfg()
  target = jnp.zeros((camera.image_size[1], camera.image_size[0], 3))

  def loss(g, proj, pose):
    cam = camera.replace(projection=proj, T_camera_world=pose)
    out = render_gaussians(g, cam, config, max_overlaps=8192)
    return jnp.mean((out.image - target) ** 2) + jnp.mean(out.image_weight)

  grads, g_proj, g_pose = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
      gaussians, camera.projection, camera.T_camera_world)

  for leaf in jax.tree.leaves(grads):
    assert bool(jnp.isfinite(leaf).all())
  assert bool(jnp.isfinite(g_proj).all()) and float(jnp.abs(g_proj).max()) > 0
  assert bool(jnp.isfinite(g_pose).all()) and float(jnp.abs(g_pose).max()) > 0
  # position gradients exist for visible points
  assert float(jnp.abs(grads.position).max()) > 0


@pytest.mark.slow
def test_render_use_depth16():
  gaussians, camera = make_scene(4)
  config = small_cfg()
  out32 = jax.jit(lambda g: render_gaussians(
      g, camera, config, max_overlaps=8192))(gaussians)
  out16 = jax.jit(lambda g: render_gaussians(
      g, camera, config, use_depth16=True, max_overlaps=8192))(gaussians)
  # images should be near-identical (ordering ties aside)
  diff = float(jnp.abs(out32.image - out16.image).max())
  assert diff < 0.2
  assert float(jnp.abs(out32.image - out16.image).mean()) < 1e-3


def test_render_tiled_loss_matches_detiled():
  """render_with_heuristics(tiled=True) keeps the image fields in tile
  layout; a masked tiled loss must produce the same loss value and
  gradients as the (H, W, C) loss — the trainer/bench path that removes
  the detile/entile transposes from the step graph."""
  from tpu_splatting import render_with_heuristics
  from tpu_splatting.mapper.tile_mapper import tile_shape
  from tpu_splatting.rasterizer.function import entile, tile_mask

  gaussians, camera = make_scene(3)
  config = small_cfg(compute_point_heuristic=True, compute_visibility=True)
  w, h = camera.image_size
  tw, th = tile_shape(camera.image_size, config.tile_size)
  tgt_full = jnp.asarray(
      np.random.default_rng(0).random((h, w, 3)).astype(np.float32))
  tgt_t = entile(tgt_full, tw, th, config.tile_size)
  mask = tile_mask(camera.image_size, tw, th, config.tile_size)

  def loss_flat(rendering):
    err = rendering.image - tgt_full
    return jnp.sum(err * err)

  def loss_tiled(rendering):
    assert rendering.tiled
    err = rendering.image - tgt_t
    return jnp.sum(mask * (err * err))

  l0, r0, g0 = render_with_heuristics(loss_flat, gaussians, camera, config,
                                      max_overlaps=8192)
  l1, r1, g1 = render_with_heuristics(loss_tiled, gaussians, camera,
                                      config, tiled=True, max_overlaps=8192)
  np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
  for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                               atol=1e-6, rtol=1e-6)
  # heuristics flow on both paths
  np.testing.assert_allclose(np.asarray(r1.points.prune_cost),
                             np.asarray(r0.points.prune_cost),
                             atol=1e-6, rtol=1e-6)
