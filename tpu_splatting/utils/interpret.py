"""Pallas interpret-mode selection.

The kernels run compiled on the GPU and interpreted on the CPU (tests and
f64 gradchecks); no kernel ever runs interpreted in a GPU process.
"""

from __future__ import annotations

import jax


def use_interpret() -> bool:
  return jax.default_backend() == "cpu"
