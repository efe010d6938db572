"""tpu_splatting — a differentiable Gaussian-splatting framework in JAX.

JAX/XLA/Pallas implementation with the capability surface of
uc-vision/taichi-splatting (see SURVEY.md): static shapes, masks instead of
host-synced compaction, Pallas (Triton) kernels for the tile-based
rasterizer on the GPU, custom_vjp instead of Taichi autodiff.

Public surface mirrors the reference package
(taichi_splatting/__init__.py:1-33).
"""

from . import perspective
from .data_types import Gaussians2D, Gaussians3D, RasterConfig
from .mapper.tile_mapper import TileMapping, map_to_tiles, pad_to_tile
from .perspective import CameraParams
from .rasterizer.function import RasterOut, rasterize, rasterize_with_tiles
from .renderer import (render_gaussians, render_projected,
                       render_with_heuristics, viewspace_gradient)
from .rendering import RenderedPoints, Rendering
from .spherical_harmonics import evaluate_sh_at

__all__ = [
    "Gaussians2D", "Gaussians3D", "RasterConfig", "CameraParams",
    "TileMapping", "map_to_tiles", "pad_to_tile",
    "RasterOut", "rasterize", "rasterize_with_tiles",
    "render_gaussians", "render_projected", "render_with_heuristics",
    "viewspace_gradient",
    "RenderedPoints", "Rendering", "evaluate_sh_at",
    "perspective",
]
