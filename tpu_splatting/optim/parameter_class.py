"""ParameterClass: parameters + row-synchronised optimizer state.

Equivalent of the reference ParameterClass
(taichi_splatting/optim/parameter_class.py:12-246): a dict of
mixed parameter/non-parameter arrays whose optimizer state stays row-aligned
under point edits — boolean/index filtering, appending (for split/prune
training) — plus checkpointing.

JAX adaptation: functional instead of mutating.  Point-count edits change
array shapes, so (like the reference, which reallocates tensors) they happen
*between* jitted steps; the jitted training step consumes
``params``/``opt_state`` as pytrees.
"""

from __future__ import annotations

import dataclasses
import pickle
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .fractional import FractionalOpt, FractionalState, GroupConfig


@dataclass
class ParameterClass:
  """Immutable container of tensors + optimizer + synchronized state."""
  tensors: Dict[str, jnp.ndarray]
  optimizer: FractionalOpt
  opt_state: FractionalState

  # ------------------------------------------------------------------
  @staticmethod
  def create(tensors: Dict[str, jnp.ndarray],
             parameter_groups: Dict[str, GroupConfig],
             optimizer_cls=None, opt_state: Optional[FractionalState] = None,
             **optim_kwargs) -> "ParameterClass":
    from .fractional import VisibilityAwareLaProp
    optimizer_cls = optimizer_cls or VisibilityAwareLaProp
    for k in parameter_groups:
      assert k in tensors, f"group {k} not in tensors {list(tensors)}"
    optimizer = optimizer_cls(parameter_groups, **optim_kwargs)
    if opt_state is None:
      opt_state = optimizer.init(tensors)
    return ParameterClass(dict(tensors), optimizer, opt_state)

  # attribute access to tensors (parameter_class.py:141-145)
  def __getattr__(self, name):
    tensors = object.__getattribute__(self, "tensors")
    if name in tensors:
      return tensors[name]
    raise AttributeError(name)

  def keys(self):
    return self.tensors.keys()

  def items(self):
    return self.tensors.items()

  def optimized_keys(self):
    return self.optimizer.groups.keys()

  @property
  def parameter_groups(self) -> Dict[str, GroupConfig]:
    return self.optimizer.groups

  @property
  def batch_size(self):
    return (next(iter(self.tensors.values())).shape[0],)

  def __len__(self):
    return self.batch_size[0]

  # ------------------------------------------------------------------
  # learning-rate management (parameter_class.py:68-92)
  def set_learning_rate(self, **rates: float) -> "ParameterClass":
    groups = {k: (cfg.replace(lr=rates[k]) if k in rates else cfg)
              for k, cfg in self.optimizer.groups.items()}
    opt = type(self.optimizer)(groups, **self._opt_kwargs())
    return dataclasses.replace(self, optimizer=opt)

  @property
  def learning_rates(self) -> Dict[str, float]:
    return {k: cfg.lr for k, cfg in self.optimizer.groups.items()}

  def _opt_kwargs(self):
    kw = {}
    if hasattr(self.optimizer, "vis_beta"):
      kw["vis_beta"] = self.optimizer.vis_beta
      kw["vis_smooth"] = self.optimizer.vis_smooth
    return kw

  # ------------------------------------------------------------------
  # optimizer step (delegates; functional)
  def step(self, grads: Dict[str, jnp.ndarray], *args,
           **kw) -> "ParameterClass":
    new_tensors, new_state = self.optimizer.step(
        self.tensors, grads, self.opt_state, *args, **kw)
    return dataclasses.replace(self, tensors=new_tensors,
                               opt_state=new_state)

  # ------------------------------------------------------------------
  # row surgery (parameter_class.py:214-243) — host-side, outside jit
  def __getitem__(self, idx):
    if isinstance(idx, str):
      return self.tensors[idx]
    idx = jnp.asarray(idx)
    if idx.dtype == jnp.bool_:
      idx = jnp.nonzero(np.asarray(idx))[0]
    tensors = {k: v[idx] for k, v in self.tensors.items()}
    opt_state = jax.tree.map(lambda x: x[idx], self.opt_state)
    return dataclasses.replace(self, tensors=tensors, opt_state=opt_state)

  def append_tensors(self, tensors: Dict[str, jnp.ndarray],
                     tensor_state: Optional[FractionalState] = None
                     ) -> "ParameterClass":
    """Concatenate new rows with zeroed (or provided) optimizer state."""
    assert set(tensors.keys()) == set(self.tensors.keys()), (
        f"{set(tensors.keys())} != {set(self.tensors.keys())}")
    n_new = next(iter(tensors.values())).shape[0]

    if tensor_state is None:
      tensor_state = jax.tree.map(
          lambda x: jnp.zeros((n_new, *x.shape[1:]), x.dtype),
          self.opt_state)

    merged = {k: jnp.concatenate([self.tensors[k], tensors[k]])
              for k in self.tensors}
    opt_state = jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                             self.opt_state, tensor_state)
    return dataclasses.replace(self, tensors=merged, opt_state=opt_state)

  def append(self, other: "ParameterClass") -> "ParameterClass":
    return self.append_tensors(other.tensors, other.opt_state)

  # ------------------------------------------------------------------
  # checkpointing (parameter_class.py:95-118)
  def state_dict(self) -> dict:
    return {
        "tensors": {k: np.asarray(v) for k, v in self.tensors.items()},
        "opt_state": jax.tree.map(np.asarray, self.opt_state),
        "parameter_groups": self.optimizer.groups,
        "optimizer_cls": type(self.optimizer).__name__,
        "optim_kwargs": self._opt_kwargs(),
    }

  @staticmethod
  def from_state_dict(state: dict) -> "ParameterClass":
    from . import fractional
    cls = getattr(fractional, state["optimizer_cls"])
    tensors = {k: jnp.asarray(v) for k, v in state["tensors"].items()}
    opt_state = jax.tree.map(jnp.asarray, state["opt_state"])
    return ParameterClass.create(
        tensors, state["parameter_groups"], optimizer_cls=cls,
        opt_state=opt_state, **state["optim_kwargs"])

  def save(self, path: str):
    with open(path, "wb") as f:
      pickle.dump(self.state_dict(), f)

  @staticmethod
  def load(path: str) -> "ParameterClass":
    with open(path, "rb") as f:
      return ParameterClass.from_state_dict(pickle.load(f))


jax.tree_util.register_dataclass(
    ParameterClass, data_fields=["tensors", "opt_state"],
    meta_fields=["optimizer"])
