"""2D gaussian path: packing, bases, split operations, 2D renderer.

Equivalent of taichi_splatting/misc/renderer2d.py (:16-148).  Pure jnp; random sampling uses explicit jax PRNG keys instead of
torch's global RNG.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..data_types import Gaussians2D, RasterConfig
from ..lib import transforms


def project_gaussians2d(points: Gaussians2D) -> jnp.ndarray:
  """Pack Gaussians2D into the (N, 7) axis/sigma representation used by the
  tile mapper and rasterizer (reference renderer2d.py:17-33)."""
  alpha = transforms.sigmoid(points.alpha_logit[:, 0])
  sigma = points.scaling
  v1 = transforms.normalize(points.rotation)
  return jnp.concatenate(
      [points.position, v1, sigma, alpha[:, None]], -1)


def point_basis(points: Gaussians2D, eps: float = 1e-4) -> jnp.ndarray:
  """Per-point scaled basis (N, 2, 2): columns v1*s1, v2*s2
  (renderer2d.py:37-43)."""
  scale = jnp.maximum(points.scaling, eps)
  v1 = transforms.normalize(points.rotation)
  v2 = jnp.stack([-v1[..., 1], v1[..., 0]], -1)
  return jnp.stack([v1, v2], -1) * scale[:, None, :]


def point_rotation(points: Gaussians2D) -> jnp.ndarray:
  v1 = transforms.normalize(points.rotation)
  v2 = jnp.stack([-v1[..., 1], v1[..., 0]], -1)
  return jnp.stack([v1, v2], 1)


def point_covariance(points: Gaussians2D) -> jnp.ndarray:
  basis = point_basis(points)
  return jnp.matmul(basis, basis.transpose(0, 2, 1),
                    precision=jax.lax.Precision.HIGHEST)


def _repeat(x, n):
  return jnp.repeat(x, n, axis=0)


def split_with_offsets(points: Gaussians2D, offsets: jnp.ndarray,
                       key: jax.Array, depth_noise: float = 1e-2
                       ) -> Gaussians2D:
  """Repeat each gaussian n times and displace by offsets
  (renderer2d.py:60-69)."""
  num_points, n, _ = offsets.shape
  rep = jax.tree.map(lambda x: _repeat(x, n), points)
  depth_jitter = jax.random.normal(key, rep.depths.shape) * depth_noise
  return rep.replace(
      position=rep.position + offsets.reshape(-1, 2),
      depths=jnp.maximum(rep.depths + depth_jitter, 1e-6))


def repeat_sample_gaussians(samples: jnp.ndarray, points: Gaussians2D,
                            n: int = 2) -> jnp.ndarray:
  basis = _repeat(point_basis(points), n)
  return jnp.matmul(basis, samples.reshape(-1, 2, 1),
                    precision=jax.lax.Precision.HIGHEST).reshape(-1, n, 2)


def split_gaussians2d(points: Gaussians2D, key: jax.Array, n: int = 2,
                      scaling: Optional[float] = None,
                      depth_noise: float = 1e-2) -> Gaussians2D:
  """Randomly-sampled split (renderer2d.py:72-97)."""
  k1, k2 = jax.random.split(key)
  samples = 0.5 * jax.random.normal(k1, (len(points), n, 2),
                                    points.position.dtype)
  offsets = repeat_sample_gaussians(samples, points, n)

  if scaling is None:
    scaling = 1 / math.sqrt(n)
  points = points.replace(log_scaling=points.log_scaling + math.log(scaling))
  return split_with_offsets(points, offsets, k2, depth_noise)


def uniform_split_gaussians2d(points: Gaussians2D, key: jax.Array, n: int = 2,
                              scaling: Optional[float] = None,
                              depth_noise: float = 1e-2, sep: float = 0.7,
                              random_axis: bool = False, eps: float = 1e-6
                              ) -> Gaussians2D:
  """Axis-aligned uniform split (renderer2d.py:110-131)."""
  k1, k2 = jax.random.split(key)

  if random_axis:
    probs = points.scaling + eps
    probs = probs / probs.sum(-1, keepdims=True)
    axis_idx = jax.random.categorical(k1, jnp.log(probs), axis=-1)
  else:
    axis_idx = jnp.argmax(points.log_scaling, -1)

  axis = jax.nn.one_hot(axis_idx, 2, dtype=points.position.dtype)
  values = jnp.linspace(-sep, sep, n, dtype=points.position.dtype)

  samples = values.reshape(1, -1, 1) * axis.reshape(-1, 1, 2)
  offsets = repeat_sample_gaussians(samples, points, n)

  if scaling is None:
    scaling = math.sqrt(n) / n
  points = points.set_scaling(points.scaling * (axis * scaling + (1 - axis)))
  return split_with_offsets(points, offsets, k2, depth_noise)


def render_gaussians(gaussians: Gaussians2D, image_size: Tuple[int, int],
                     raster_config: RasterConfig = RasterConfig(),
                     max_overlaps: Optional[int] = None,
                     heuristic_probe: Optional[jnp.ndarray] = None):
  """2D toy-render entry point (renderer2d.py:134-148)."""
  from ..rasterizer.function import rasterize

  gaussians2d = project_gaussians2d(gaussians)
  return rasterize(
      gaussians2d=gaussians2d,
      depth=jnp.clip(gaussians.depths, 0.0, 1.0),
      features=gaussians.feature,
      image_size=image_size,
      config=raster_config,
      max_overlaps=max_overlaps,
      heuristic_probe=heuristic_probe)


def render_with_heuristics(loss_fn, gaussians: Gaussians2D,
                           image_size: Tuple[int, int],
                           config: RasterConfig = RasterConfig(),
                           max_overlaps: Optional[int] = None):
  """2D analogue of renderer.render_with_heuristics: render, evaluate
  ``loss_fn(out, gaussians)``, and return ``(loss, out, grads)`` with
  ``out.point_heuristic`` populated (columns: prune_cost, split_score) from
  the same backward pass as ``grads`` (a Gaussians2D cotangent pytree)."""
  assert config.compute_point_heuristic, (
      "render_with_heuristics requires config.compute_point_heuristic")
  probe = jnp.zeros((gaussians.position.shape[0], 2),
                    gaussians.position.dtype)

  def wrapped(g, probe):
    out = render_gaussians(g, image_size, config, max_overlaps,
                           heuristic_probe=probe)
    return loss_fn(out, g), out

  (loss, out), (grads, gpr) = jax.value_and_grad(
      wrapped, argnums=(0, 1), has_aux=True)(gaussians, probe)
  return loss, out._replace(point_heuristic=gpr), grads
