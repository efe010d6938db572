"""Raster kernels (Pallas, interpret mode here) against the plain XLA version
(ref_lib.raster_plain) and the numpy f64 oracle: forward images, visibility,
per-point gradients and heuristics, in blending, quantile and antialiased
modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradcheck import check_grads

from tpu_splatting import RasterConfig
from tpu_splatting.mapper.tile_mapper import map_to_tiles
from tpu_splatting.misc.renderer2d import project_gaussians2d
from tpu_splatting.rasterizer.function import (rasterize, rasterize_with_tiles,
                                               raster_impl)
from tpu_splatting.rasterizer.reference import rasterize_reference

from random_data import random_2d_gaussians


def make_scene(seed, n=40, image_size=(24, 16), num_channels=3,
               alpha_range=(0.1, 0.9), scale_factor=1.0):
  rng = np.random.default_rng(seed)
  g2 = random_2d_gaussians(rng, n, image_size, num_channels=num_channels,
                           scale_factor=scale_factor, alpha_range=alpha_range,
                           dtype=jnp.float64)
  return g2, project_gaussians2d(g2)


def raster_grads(impl, packed, g2, image_size, config, weights):
  """Forward outputs and gradients w.r.t. rows, features and the probe."""
  def loss(packed, feats, probe):
    out = rasterize(packed, g2.depths, feats, image_size, config,
                    max_overlaps=1024, heuristic_probe=probe)
    val = (jnp.sum(weights[..., :-1] * out.image)
           + jnp.sum(weights[..., -1] * out.image_weight))
    return val, out

  probe = jnp.zeros((packed.shape[0], 2), packed.dtype)
  with raster_impl(impl, impl):
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(packed, g2.feature,
                                                       probe)
  return out, grads


# scenes by seed; "saturated" has large, nearly opaque splats, so tiles
# saturate before their last row
SCENES = {0: dict(seed=20), 1: dict(seed=21),
          "saturated": dict(seed=5, n=60, scale_factor=3.0,
                            alpha_range=(0.995, 0.999))}


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("heuristics", [False, True])
def test_kernel_matches_plain(scene, antialias, heuristics):
  """Pallas forward + backward == plain XLA version, to f64 rounding; rows
  past a saturated tile's stop give zero gradients, heuristics and
  visibility, as in the plain version."""
  config = RasterConfig(tile_size=8, antialias=antialias,
                        compute_visibility=True,
                        compute_point_heuristic=heuristics)
  image_size = (24, 16)
  g2, packed = make_scene(image_size=image_size, **SCENES[scene])
  weights = jnp.asarray(np.random.default_rng(
      list(SCENES).index(scene)).standard_normal((16, 24, 4)))
  out_k, grads_k = raster_grads("pallas", packed, g2, image_size, config,
                                weights)
  out_p, grads_p = raster_grads("plain", packed, g2, image_size, config,
                                weights)
  if scene == "saturated":
    alpha = np.asarray(out_p.image_weight).reshape(2, 8, 3, 8)
    saturated = (alpha >= config.saturate_threshold).all(axis=(1, 3))
    assert saturated.sum() >= 2, saturated
  np.testing.assert_allclose(out_k.image, out_p.image, atol=1e-10)
  np.testing.assert_allclose(out_k.visibility, out_p.visibility, atol=1e-10)
  for gk, gp in zip(grads_k, grads_p):
    np.testing.assert_allclose(gk, gp, atol=1e-9, rtol=1e-9)
  if heuristics:
    assert float(jnp.abs(grads_k[2]).max()) > 0


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("antialias", [False, True])
def test_kernel_backward_matches_oracle_fd(seed, antialias):
  """Directional derivatives of the numpy f64 oracle's image (central
  differences) == the kernel backward's gradient along the direction."""
  config = RasterConfig(tile_size=8, antialias=antialias)
  image_size = (16, 16)
  g2, packed = make_scene(seed + 40, n=16, image_size=image_size,
                          scale_factor=0.8)
  rng = np.random.default_rng(seed)
  weights = rng.standard_normal((16, 16, 4))
  mapping = map_to_tiles(packed, g2.depths, image_size, config,
                         max_overlaps=512, features=g2.feature)

  def oracle_loss(p, f):
    img, alpha, _ = rasterize_reference(p, f, mapping, image_size, config)
    return float(np.sum(weights[..., :3] * img)
                 + np.sum(weights[..., 3] * alpha))

  def loss(p, f):
    out = rasterize_with_tiles(p, f, mapping, image_size, config)
    return (jnp.sum(weights[..., :3] * out.image)
            + jnp.sum(weights[..., 3] * out.image_weight))

  g_p, g_f = jax.grad(loss, argnums=(0, 1))(packed, g2.feature)
  p0, f0 = np.asarray(packed), np.asarray(g2.feature)
  dp = rng.standard_normal(p0.shape) * np.asarray([1, 1, 0, 0, 1, 1, 0])
  df = rng.standard_normal(f0.shape)
  eps = 1e-6
  numeric = (oracle_loss(p0 + eps * dp, f0 + eps * df)
             - oracle_loss(p0 - eps * dp, f0 - eps * df)) / (2 * eps)
  analytic = float(np.sum(np.asarray(g_p) * dp) + np.sum(np.asarray(g_f) * df))
  np.testing.assert_allclose(analytic, numeric, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("blending", [True, False])
def test_plain_forward_matches_oracle(seed, antialias, blending):
  config = RasterConfig(tile_size=8, antialias=antialias,
                        use_alpha_blending=blending, compute_visibility=True,
                        saturate_threshold=0.9999 if blending else 0.25)
  image_size = (24, 16)
  g2, packed = make_scene(seed + 60, n=50, image_size=image_size,
                          alpha_range=(0.1, 0.9) if blending else (0.4, 0.95))
  mapping = map_to_tiles(packed, g2.depths, image_size, config,
                         max_overlaps=2048)
  with raster_impl("plain", "plain"):
    out = rasterize_with_tiles(packed, g2.feature, mapping, image_size,
                               config)
  ref_img, ref_alpha, ref_vis = rasterize_reference(
      packed, g2.feature, mapping, image_size, config)
  np.testing.assert_allclose(np.asarray(out.image), ref_img, atol=1e-10)
  np.testing.assert_allclose(np.asarray(out.image_weight), ref_alpha,
                             atol=1e-10)
  np.testing.assert_allclose(np.asarray(out.visibility), ref_vis, atol=1e-10)


@pytest.mark.parametrize("antialias", [False, True])
def test_plain_gradcheck(antialias):
  """f64 gradcheck of the plain version's backward."""
  config = RasterConfig(tile_size=8, antialias=antialias)
  image_size = (8, 8)
  g2, _ = make_scene(3, n=14, image_size=image_size, num_channels=2,
                     scale_factor=0.8)
  axis = g2.rotation / jnp.linalg.norm(g2.rotation, axis=1, keepdims=True)
  alpha = jax.nn.sigmoid(g2.alpha_logit[:, 0])

  def f(mean, sigma, alpha, feats):
    packed = jnp.concatenate([mean, axis, sigma, alpha[:, None]], -1)
    with raster_impl("plain", "plain"):
      out = rasterize(packed, g2.depths, feats, image_size, config,
                      max_overlaps=64)
    return out.image, out.image_weight

  check_grads(f, (g2.position, g2.scaling, alpha, g2.feature), rtol=5e-5,
              atol=5e-7, eps=1e-7, n_directions=2)


@pytest.mark.gpu
@pytest.mark.parametrize("saturated", [False, True])
def test_kernels_compile_on_card(gpu, saturated):
  """The Pallas kernels compile for the card and match the plain version,
  also where tiles saturate before their last row (run on the card with
  ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``)."""
  config = RasterConfig(tile_size=16, compute_visibility=True,
                        compute_point_heuristic=True)
  image_size = (64, 48)
  g2, packed = make_scene(0, n=60 if saturated else 200,
                          image_size=image_size,
                          scale_factor=3.0 if saturated else 1.0,
                          alpha_range=(0.995, 0.999) if saturated
                          else (0.1, 0.9))
  packed = packed.astype(jnp.float32)
  g2 = g2.replace(feature=g2.feature.astype(jnp.float32),
                  depths=g2.depths.astype(jnp.float32))
  weights = jnp.ones((48, 64, 4), jnp.float32)
  out_k, grads_k = raster_grads("pallas", packed, g2, image_size, config,
                                weights)
  with jax.default_matmul_precision("highest"):
    out_p, grads_p = raster_grads("plain", packed, g2, image_size, config,
                                  weights)
  assert int(out_k.num_overflow) == 0
  if saturated:
    assert float(out_p.image_weight.min()) >= config.saturate_threshold - 1e-6
  np.testing.assert_allclose(out_k.image, out_p.image, atol=1e-4)
  np.testing.assert_allclose(out_k.visibility, out_p.visibility, atol=1e-4,
                             rtol=1e-4)
  for gk, gp in zip(grads_k, grads_p):
    np.testing.assert_allclose(gk, gp, atol=1e-3, rtol=1e-3)
