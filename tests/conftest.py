"""Test configuration: run on CPU (8 virtual devices) with x64 enabled,
unless ``JAX_PLATFORMS`` names another backend.

Mirrors the reference test strategy (SURVEY.md §4): the same kernels run on a
"CPU backend in float64" for numerically exact gradient checking — here via
JAX's CPU backend + Pallas interpret mode, with an 8-device virtual mesh for
multi-device sharding tests.  Tests marked ``gpu`` need an NVIDIA card and
skip elsewhere; on a card run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(``chip_smoke.py`` runs the same comparisons at full size).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
  flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# The fast tier is XLA:CPU COMPILE-bound; tests don't need optimized CPU
# code, so drop the backend optimization level (faster compiles).
if "xla_backend_optimization_level" not in flags:
  flags = (flags + " --xla_backend_optimization_level=0").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

from tpu_splatting.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


@pytest.fixture
def gpu():
  """Skips the test unless an NVIDIA card is JAX's default backend."""
  if jax.default_backend() != "gpu":
    pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda pytest -m gpu")
