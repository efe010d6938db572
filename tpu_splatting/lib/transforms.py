"""Quaternion / rigid-transform math (pure jnp, batched over leading axes).

Re-design of the quaternion and transform helpers in the reference
library (see taichi_splatting/taichi_lib/generic.py:407-485 and
torch_lib/transforms.py:5-49 for the behaviour being reproduced).  All
functions are dtype-polymorphic (f32 on the GPU, f64 on CPU for gradcheck) and
vectorised over arbitrary leading batch dimensions.

Quaternion layout: ``(x, y, z, w)`` — i.e. ``q[..., 3]`` is the scalar part,
matching the component unpacking used by the reference kernels
(generic.py:408 ``x, y, z, w = q``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
  """Unit quaternion (..., 4) [xyzw] -> rotation matrix (..., 3, 3).

  Mirrors generic.py:407-416.
  """
  x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  x2, y2, z2 = x * x, y * y, z * z

  row0 = jnp.stack([1 - 2 * y2 - 2 * z2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y], -1)
  row1 = jnp.stack([2 * x * y + 2 * w * z, 1 - 2 * x2 - 2 * z2, 2 * y * z - 2 * w * x], -1)
  row2 = jnp.stack([2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x2 - 2 * y2], -1)
  return jnp.stack([row0, row1, row2], -2)


def scaled_quat_to_mat(q: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
  """R(q) @ diag(s) without forming the diagonal (generic.py:419-427)."""
  return quat_to_mat(q) * s[..., None, :]


def quat_mul(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
  """Hamilton product in xyzw layout (generic.py:468-474)."""
  x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
  x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
  return jnp.stack([
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
  ], -1)


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
  return jnp.concatenate([-q[..., :3], q[..., 3:]], -1)


def normalize(v: jnp.ndarray, axis: int = -1, eps: float = 1e-12) -> jnp.ndarray:
  """Safe normalise — zero vectors map to zero rather than NaN."""
  n = jnp.sqrt(jnp.sum(v * v, axis=axis, keepdims=True))
  return v / jnp.maximum(n, eps)


def join_rt(r: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
  """(...,3,3) rotation + (...,3) translation -> (...,4,4) homogeneous."""
  batch = jnp.broadcast_shapes(r.shape[:-2], t.shape[:-1])
  r = jnp.broadcast_to(r, batch + (3, 3))
  t = jnp.broadcast_to(t, batch + (3,))
  top = jnp.concatenate([r, t[..., :, None]], -1)
  bottom = jnp.zeros(batch + (1, 4), dtype=r.dtype).at[..., 0, 3].set(1.0)
  return jnp.concatenate([top, bottom], -2)


def split_rt(rt: jnp.ndarray):
  return rt[..., :3, :3], rt[..., :3, 3]


def make_homog(p: jnp.ndarray) -> jnp.ndarray:
  return jnp.concatenate([p, jnp.ones_like(p[..., :1])], -1)


def transform44(m: jnp.ndarray, p_homog: jnp.ndarray) -> jnp.ndarray:
  return jnp.matmul(p_homog, m.swapaxes(-1, -2),
                    precision=jax.lax.Precision.HIGHEST)


def transform_points(m44: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
  """Apply a 4x4 rigid/projective transform to (..., 3) points (drops w)."""
  ph = transform44(m44, make_homog(p))
  return ph[..., :3]


def sigmoid(x: jnp.ndarray) -> jnp.ndarray:
  return 1.0 / (1.0 + jnp.exp(-x))


def inverse_sigmoid(x: jnp.ndarray) -> jnp.ndarray:
  return jnp.log(x) - jnp.log1p(-x)
