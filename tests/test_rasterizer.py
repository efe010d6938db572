"""Rasterizer tests: pixel-exact comparison against the sequential oracle,
f64 gradcheck of the custom_vjp (mirrors reference tests/test_rasterizer.py),
quantile mode, and the heuristic probe."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradcheck import check_grads

from tpu_splatting import RasterConfig
from tpu_splatting.mapper.tile_mapper import map_to_tiles
from tpu_splatting.misc.renderer2d import project_gaussians2d
from tpu_splatting.rasterizer.function import rasterize, rasterize_with_tiles
from tpu_splatting.rasterizer.reference import rasterize_reference

from random_data import random_2d_gaussians


def make_scene(seed, n=40, image_size=(32, 24), num_channels=3,
               dtype=jnp.float64, scale_factor=1.0, alpha_range=(0.1, 0.9)):
  rng = np.random.default_rng(seed)
  g2 = random_2d_gaussians(rng, n, image_size, num_channels=num_channels,
                           scale_factor=scale_factor, alpha_range=alpha_range,
                           dtype=dtype)
  packed = project_gaussians2d(g2)
  return g2, packed


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("antialias", [False, True])
def test_forward_matches_oracle(seed, antialias):
  config = RasterConfig(tile_size=8, antialias=antialias,
                        compute_visibility=True)
  image_size = (32, 24)
  g2, packed = make_scene(seed, n=50, image_size=image_size)

  mapping = map_to_tiles(packed, g2.depths, image_size, config,
                         max_overlaps=1024)
  assert int(mapping.num_overflow) == 0

  out = rasterize_with_tiles(packed, g2.feature, mapping, image_size, config)

  ref_img, ref_alpha, ref_vis = rasterize_reference(
      packed, g2.feature, mapping, image_size, config)

  np.testing.assert_allclose(np.asarray(out.image), ref_img, atol=1e-10)
  np.testing.assert_allclose(np.asarray(out.image_weight), ref_alpha,
                             atol=1e-10)
  np.testing.assert_allclose(np.asarray(out.visibility), ref_vis, atol=1e-10)


@pytest.mark.parametrize("seed", range(4))
def test_forward_matches_oracle_quantile(seed):
  """Non-blending (median / quantile) mode."""
  config = RasterConfig(tile_size=8, use_alpha_blending=False,
                        saturate_threshold=0.25, compute_visibility=True)
  image_size = (24, 16)
  g2, packed = make_scene(seed + 50, n=60, image_size=image_size,
                          num_channels=1, alpha_range=(0.4, 0.95),
                          scale_factor=2.0)

  mapping = map_to_tiles(packed, g2.depths, image_size, config,
                         max_overlaps=2048)
  assert int(mapping.num_overflow) == 0

  out = rasterize_with_tiles(packed, g2.feature, mapping, image_size, config)
  ref_img, ref_alpha, ref_vis = rasterize_reference(
      packed, g2.feature, mapping, image_size, config)

  np.testing.assert_allclose(np.asarray(out.image), ref_img, atol=1e-10)
  np.testing.assert_allclose(np.asarray(out.image_weight), ref_alpha,
                             atol=1e-10)
  np.testing.assert_allclose(np.asarray(out.visibility), ref_vis, atol=1e-10)


# seed coverage: 30 seeds x 2 modes = 60 gradchecks; seeds 0-1 run in the
# default (fast) tier, the rest in the slow tier (reference runs 100 seeds,
# tests/test_rasterizer.py:62-90)
@pytest.mark.parametrize(
    "seed", [0,
             *(pytest.param(s, marks=pytest.mark.slow)
               for s in range(1, 30))])
@pytest.mark.parametrize("antialias", [False, True])
def test_rasterizer_gradcheck(seed, antialias):
  """f64 gradcheck of the hand-written backward, through the full pipeline
  on a single tile (the reference's key trick, tests/test_rasterizer.py:41)."""
  config = RasterConfig(tile_size=8, antialias=antialias)
  image_size = (8, 8)
  rng = np.random.default_rng(seed)
  n = 14
  g2 = random_2d_gaussians(rng, n, image_size, num_channels=2,
                           scale_factor=0.8, dtype=jnp.float64)

  mean = g2.position
  axis = g2.rotation / jnp.linalg.norm(g2.rotation, axis=1, keepdims=True)
  sigma = g2.scaling
  alpha = jax.nn.sigmoid(g2.alpha_logit[:, 0])
  depth = g2.depths
  feats = g2.feature

  def f(mean, axis, sigma, alpha, feats):
    packed = jnp.concatenate([mean, axis, sigma, alpha[:, None]], -1)
    out = rasterize(packed, depth, feats, image_size, config,
                    max_overlaps=64)
    return out.image, out.image_weight

  # 2 random directions: each costs 2 interpret-mode f64 evals (the fast
  # tier's single largest execution item); breadth comes from the slow
  # tier's 29 extra seeds
  check_grads(f, (mean, axis, sigma, alpha, feats), rtol=5e-5, atol=5e-7,
              eps=1e-7, n_directions=2)


def test_saturation_freeze():
  """Many opaque overlapping gaussians: transmittance freezes, image stays
  bounded, and the frozen tail contributes nothing."""
  config = RasterConfig(tile_size=8)
  image_size = (8, 8)
  n = 64
  # identical opaque gaussians stacked on the same spot
  packed = jnp.tile(jnp.asarray([[4.0, 4.0, 1.0, 0.0, 3.0, 3.0, 0.95]]),
                    (n, 1)).astype(jnp.float64)
  feats = jnp.ones((n, 1), jnp.float64)
  depth = jnp.linspace(0.1, 0.9, n, dtype=jnp.float64)

  out = rasterize(packed, depth, feats, image_size, config, max_overlaps=128)
  img = np.asarray(out.image)
  alpha = np.asarray(out.image_weight)
  assert np.all(img <= 1.0 + 1e-9)
  assert np.all(alpha <= 1.0)
  assert alpha.max() > 0.999  # saturated at the centre


@pytest.mark.slow
def test_heuristic_probe_gradients():
  """The probe cotangent carries (prune_cost, split_score); visible points
  get positive prune cost, invisible points get exactly zero."""
  config = RasterConfig(tile_size=8, compute_point_heuristic=True,
                        compute_visibility=True)
  image_size = (16, 16)
  g2, packed = make_scene(3, n=30, image_size=image_size)

  # push half the gaussians far outside the image
  packed = packed.at[15:, 0].add(1e4)

  probe = jnp.zeros((30, 2), jnp.float64)
  target = jnp.zeros((16, 16, 3), jnp.float64)

  def loss(packed, probe):
    out = rasterize(packed, g2.depths, g2.feature, image_size, config,
                    max_overlaps=512, heuristic_probe=probe)
    return jnp.sum((out.image - target) ** 2), out.visibility

  (g_packed, g_probe), vis = jax.grad(loss, argnums=(0, 1), has_aux=True)(
      packed, probe)

  vis = np.asarray(vis)
  heur = np.asarray(g_probe)
  assert heur.shape == (30, 2)
  assert np.all(heur >= 0)
  # points with visibility should have heuristics; culled points exactly 0
  visible = vis > 1e-6
  assert visible.any() and (~visible).any()
  assert np.all(heur[~visible] == 0)
  assert np.any(heur[visible, 0] > 0)
  # packed gradients exist for visible, zero for invisible
  g_packed = np.asarray(g_packed)
  assert np.all(g_packed[~visible] == 0)
  assert np.any(np.abs(g_packed[visible]) > 0)


def test_visibility_equals_feature_gradient():
  """The visibility invariant (reference tests/test_visibility.py:34-64):
  under an all-ones image gradient, the feature gradient of a 1-channel
  rasterization equals the forward-computed visibility."""
  config = RasterConfig(tile_size=8, compute_visibility=True)
  image_size = (32, 32)
  g2, packed = make_scene(7, n=60, image_size=image_size, num_channels=1)

  def f(feats):
    out = rasterize(packed, g2.depths, feats, image_size, config,
                    max_overlaps=1024)
    return jnp.sum(out.image)

  grad_feats = jax.grad(f)(g2.feature)
  out = rasterize(packed, g2.depths, g2.feature, image_size, config,
                  max_overlaps=1024)

  np.testing.assert_allclose(np.asarray(grad_feats)[:, 0],
                             np.asarray(out.visibility), atol=1e-10)
