"""Fractional (visibility-weighted) sparse optimizers — pure jnp.

Equivalent of the reference optimizer subsystem
(taichi_splatting/optim/fractional.py:109-229 and the Taichi
kernels in optim/fractional_adam.py / fractional_laprop.py).  The updates are
per-point gathers + elementwise math, so no Pallas kernel is needed — XLA
fuses the whole step.

Key semantic: EMA decays are raised to the power of the per-point visibility
weight ``w`` (``lerp(beta**w, state, new)``), bias correction uses the
accumulated ``total_weight`` and the applied step is scaled by
``saturate(w) = 1 - exp(-2w)`` (fractional.py:157-158, fractional_adam.py:
30-42).

Divergence from the reference: there is no index compaction — the step is
dense over all N points with ``weight = 0`` for invisible points, which is a
no-op by construction (``beta**0 = 1`` leaves the EMAs unchanged and
``saturate(0) = 0`` zeroes the applied step).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp


def lerp(t, a, b):
  """a * t + b * (1 - t) (taichi_lib/generic.py:489-490)."""
  return a * t + b * (1.0 - t)


def saturate(x):
  """1 - exp(-2x) (fractional.py:157-158)."""
  return 1.0 - jnp.exp(-2.0 * x)


def power_lerp(t, a, b, k=2):
  """lerp on k-th powers (visibility_aware.py:32-33)."""
  return (a ** k + (b ** k - a ** k) * t) ** (1.0 / k)


@dataclass(frozen=True)
class GroupConfig:
  """Per-parameter-group hyperparameters (reference fractional.py:11-29)."""
  type: str = "scalar"            # "scalar" | "vector" | "local_vector"
  lr: float = 0.001
  betas: Tuple[float, float] = (0.9, 0.999)
  eps: float = 1e-16
  bias_correction: bool = True
  clip: Optional[float] = None
  # extra hyperparameters (ignored by the step; kept for trainers)
  extra: Dict[str, float] = field(default_factory=dict)

  def replace(self, **kw):
    return dataclasses.replace(self, **kw)


def init_group_state(param: jnp.ndarray, cfg: GroupConfig):
  """m/v state rows (reference optim/util.py:5-18)."""
  p2 = param.reshape(param.shape[0], -1)
  if cfg.type == "scalar":
    return {"m": jnp.zeros_like(p2), "v": jnp.zeros_like(p2)}
  else:  # vector / local_vector: vector m, scalar v (running grad norm)
    return {"m": jnp.zeros_like(p2),
            "v": jnp.zeros((p2.shape[0],), p2.dtype)}


def _bias_adam(total_weight, betas, eps):
  b1, b2 = betas
  tw = jnp.maximum(total_weight, 1e-12)
  return jnp.sqrt(1.0 - b2 ** tw) / (1.0 - b1 ** tw + 1e-30)


def adam_update(cfg: GroupConfig, state, grad, weight, total_weight):
  """Fractional Adam (fractional_adam.py:8-85).

  Returns (lr_step (N, D), new_state); caller applies masking/scaling.
  """
  b1, b2 = cfg.betas
  w = weight[:, None]
  bias = (_bias_adam(total_weight, cfg.betas, cfg.eps)
          if cfg.bias_correction else jnp.ones_like(total_weight))

  if cfg.type == "scalar":
    m = lerp(b1 ** w, state["m"], grad)
    v = lerp(b2 ** w, state["v"], grad * grad)
    lr_step = m / jnp.maximum(jnp.sqrt(v), cfg.eps) * bias[:, None] * cfg.lr
  else:
    m = lerp(b1 ** w, state["m"], grad)
    norm = jnp.sum(grad * grad, -1)
    v = lerp(b2 ** weight, state["v"], norm)
    lr_step = (m / jnp.maximum(jnp.sqrt(v), cfg.eps)[:, None]
               * bias[:, None] * cfg.lr)
  return lr_step, {"m": m, "v": v}


def laprop_update(cfg: GroupConfig, state, grad, weight, total_weight):
  """Fractional LaProp (fractional_laprop.py:8-88): normalise the gradient
  by the bias-corrected second moment before the momentum average."""
  b1, b2 = cfg.betas
  w = weight[:, None]
  tw = jnp.maximum(total_weight, 1e-12)
  if cfg.bias_correction:
    bias1 = (1.0 - b1 ** tw)[:, None]
    bias2 = (1.0 - b2 ** tw)
  else:
    bias1 = jnp.ones((grad.shape[0], 1), grad.dtype)
    bias2 = jnp.ones((grad.shape[0],), grad.dtype)

  if cfg.type == "scalar":
    v = lerp(b2 ** w, state["v"], grad * grad)
    g_norm = grad / jnp.maximum(jnp.sqrt(v / bias2[:, None]), cfg.eps)
    m = lerp(b1 ** w, state["m"], g_norm)
    lr_step = m * cfg.lr / bias1
  else:
    norm = jnp.sum(grad * grad, -1)
    v = lerp(b2 ** weight, state["v"], norm)
    g_norm = grad / jnp.maximum(jnp.sqrt(v / bias2), cfg.eps)[:, None]
    m = lerp(b1 ** w, state["m"], g_norm)
    lr_step = m * cfg.lr / bias1
  return lr_step, {"m": m, "v": v}


_UPDATES = {"adam": adam_update, "laprop": laprop_update}


def weighted_step(kind: str, cfg: GroupConfig, state, grad, weight,
                  total_weight, basis: Optional[jnp.ndarray] = None,
                  mask_lr: Optional[jnp.ndarray] = None,
                  point_lr: Optional[jnp.ndarray] = None):
  """One fractional update for a group (reference fractional.py:109-155).

  All arrays are dense over N points; ``weight`` is 0 for invisible points
  (their state is untouched and their step is 0).
  """
  shape = grad.shape
  grad = grad.reshape(shape[0], -1)
  active = weight > 0

  if cfg.type == "local_vector":
    assert basis is not None, "basis is required for local_vector optimizer"
    inv_basis = jnp.linalg.inv(basis)
    grad = jnp.einsum("bij,bj->bi", inv_basis, grad,
                      precision=jax.lax.Precision.HIGHEST)

  lr_step, new_state = _UPDATES[kind](cfg, state, grad, weight, total_weight)

  if cfg.clip is not None:
    max_step = cfg.lr * cfg.clip
    lr_step = jnp.clip(lr_step, -max_step, max_step)

  if cfg.type == "local_vector":
    lr_step = jnp.einsum("bij,bj->bi", basis, lr_step,
                         precision=jax.lax.Precision.HIGHEST)

  if mask_lr is not None:
    lr_step = lr_step * mask_lr.reshape(1, -1)
  if point_lr is not None:
    lr_step = lr_step * point_lr[:, None]

  lr_step = jnp.where(jnp.isfinite(lr_step), lr_step, 0.0)
  lr_step = jnp.where(active[:, None], lr_step, 0.0)

  # freeze state rows for invisible points (beta**0 == 1 already implies
  # this for the EMAs; enforce it against float error)
  new_state = jax.tree.map(
      lambda new, old: jnp.where(
          active.reshape((-1,) + (1,) * (new.ndim - 1)), new, old),
      new_state, state)

  step = lr_step * saturate(weight)[:, None]
  return step.reshape(shape), new_state


# ---------------------------------------------------------------------------
# Functional optimizer front-ends (reference fractional.py:161-229)
# ---------------------------------------------------------------------------


@dataclass
class FractionalState:
  groups: Dict[str, dict]
  total_weight: jnp.ndarray
  running_vis: jnp.ndarray


jax.tree_util.register_dataclass(
    FractionalState, data_fields=["groups", "total_weight", "running_vis"],
    meta_fields=[])


class FractionalOpt:
  """Fractional optimizer over a dict of parameter arrays.

  Functional: ``state = opt.init(params)``;
  ``params, state = opt.step(params, grads, state, weight, basis=...)``.
  """

  kind = "adam"

  def __init__(self, groups: Dict[str, GroupConfig]):
    self.groups = groups

  def init(self, params: Dict[str, jnp.ndarray]) -> FractionalState:
    n = next(iter(params.values())).shape[0]
    dtype = next(iter(params.values())).dtype
    return FractionalState(
        groups={k: init_group_state(params[k], cfg)
                for k, cfg in self.groups.items()},
        total_weight=jnp.zeros((n,), dtype),
        running_vis=jnp.zeros((n,), dtype),
    )

  def step(self, params, grads, state: FractionalState, weight: jnp.ndarray,
           basis: Optional[jnp.ndarray] = None,
           mask_lr: Optional[Dict[str, jnp.ndarray]] = None,
           point_lr: Optional[Dict[str, jnp.ndarray]] = None):
    total_weight = state.total_weight + weight

    new_params = dict(params)
    new_groups = dict(state.groups)
    for name, cfg in self.groups.items():
      if name not in grads or grads[name] is None:
        continue
      step, gstate = weighted_step(
          self.kind, cfg, state.groups[name], grads[name], weight,
          total_weight, basis=basis,
          mask_lr=None if mask_lr is None else mask_lr.get(name),
          point_lr=None if point_lr is None else point_lr.get(name))
      new_params[name] = params[name] - step
      new_groups[name] = gstate

    return new_params, FractionalState(
        groups=new_groups, total_weight=total_weight,
        running_vis=state.running_vis)


class FractionalAdam(FractionalOpt):
  kind = "adam"


class FractionalLaProp(FractionalOpt):
  kind = "laprop"


class SparseAdam(FractionalAdam):
  """weight == 1 for all visible points (fractional.py:213-220)."""

  def step(self, params, grads, state, visible_mask, **kw):
    weight = visible_mask.astype(state.total_weight.dtype)
    return super().step(params, grads, state, weight, **kw)


class SparseLaProp(FractionalLaProp):
  def step(self, params, grads, state, visible_mask, **kw):
    weight = visible_mask.astype(state.total_weight.dtype)
    return super().step(params, grads, state, weight, **kw)


class VisibilityOptimizer(FractionalOpt):
  """Visibility-aware variant (visibility_aware.py:55-126): maintains a
  running visibility EMA (power-lerp k=4), weights steps by
  visibility/running_vis and normalises gradients by the visibility."""

  def __init__(self, groups: Dict[str, GroupConfig], vis_beta: float = 0.5,
               vis_smooth: float = 0.01):
    super().__init__(groups)
    self.vis_beta = vis_beta
    self.vis_smooth = vis_smooth

  def step(self, params, grads, state: FractionalState,
           visibility: jnp.ndarray, basis: Optional[jnp.ndarray] = None,
           **kw):
    visible = visibility > 0

    updated_vis = power_lerp(self.vis_beta, visibility, state.running_vis,
                             k=4)
    updated_vis = jnp.where(visible, updated_vis, state.running_vis)
    weight = jnp.where(
        visible, visibility / jnp.maximum(updated_vis, 1e-12), 0.0)

    # normalise gradients by visibility (visibility_aware.py:99-101)
    norm_grads = {
        k: g / (visibility + self.vis_smooth).reshape(
            (-1,) + (1,) * (g.ndim - 1))
        for k, g in grads.items() if g is not None}

    new_params, new_state = super().step(
        params, norm_grads, state, weight, basis=basis, **kw)
    return new_params, dataclasses.replace(new_state,
                                           running_vis=updated_vis)


class VisibilityAwareAdam(VisibilityOptimizer):
  kind = "adam"


class VisibilityAwareLaProp(VisibilityOptimizer):
  kind = "laprop"
