"""NLOS surface optimization in PyTorch, with hand-written CUDA kernels.

The PyTorch + CUDA port of ``nlos_surface_optimization_tpu`` (which stays
the reference).  Module names follow the JAX package.  This package
imports torch and numpy only, never jax.

  geometry/  mesh tensors, threefry sampling, Möller–Trumbore visibility
  render/    forward transient + analytic vertex gradient; the CUDA
             kernels' wrappers (fused_kernels K1, bwd_kernels K2)
  optim/     Adam_Modified, losses
  csrc/      the CUDA sources, built with nvcc on first use (_cuda.py)

Entry points run on the device of the mesh they are given; ``make_mesh``
puts it on CUDA unless ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import RenderConfig, make_confocal_scan, num_bins_for  # noqa: F401
from .geometry.mesh import (  # noqa: F401
    Mesh,
    face_normals_areas,
    make_mesh,
    pad_mesh,
    vertex_normals,
)
from .geometry.sampling import key, key_from_data  # noqa: F401
from .render.api import (  # noqa: F401
    inverse_render,
    inverse_render_host,
    render_intensity,
    render_intensity_host,
    render_transient,
    render_transient_host,
)
from .render.regularizers import curvature_gradient, normal_smoothing  # noqa: F401
