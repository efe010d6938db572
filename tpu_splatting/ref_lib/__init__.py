"""Ground-truth reference implementations (the torch_lib analogue).

Deliberately independent, naive re-implementations of every differentiable
op, used to diff the production kernels against (reference layer L5,
taichi_splatting/torch_lib/).  Pure jnp/numpy; run them in
f64 on CPU for exact comparisons.  Not a performance path.
"""

from .projection import reference_project
from .spherical_harmonics import reference_sh
from .rasterizer import rasterize_reference

__all__ = ["reference_project", "reference_sh", "rasterize_reference"]
