"""NLOS surface optimization in PyTorch, with hand-written CUDA kernels.

The PyTorch + CUDA port of ``nlos_surface_optimization_tpu`` (which stays
the reference).  Module names follow the JAX package.  This package
imports torch and numpy only, never jax.

  geometry/     mesh tensors, threefry sampling, Möller–Trumbore
                visibility, remeshing (geomlib), topology
  render/       forward transient and its analytic gradients (vertex,
                albedo, GGX roughness; measured jitter kernel; per-bin
                diagnostic), the GGX BRDF (brdf), the autograd twin, the
                CUDA kernels' wrappers (fused_kernels K1, bwd_kernels K2,
                occl_kernels K3), regularizers
  optim/        Adam_Modified, losses, the outer loop, material estimation
  recon/        LCT initialization
  io/           OBJ and .mat interop, checkpoints, the jitter calibration
  utils/        v2 metrics
  experiments/  scenes, GT generation, the end-to-end runner
  csrc/         the CUDA sources, built with nvcc on first use (_cuda.py)

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
    inverse_render_albedo,
    inverse_render_alpha,
    inverse_render_host,
    inverse_render_jitter,
    inverse_shading_render,
    render_intensity,
    render_intensity_host,
    render_transient,
    render_transient_host,
    render_transient_jitter,
    transient_loss_and_grad,
    vertex_gradient_bins,
)
from .render.autograd_twin import twin_transient  # noqa: F401
from .render.kernels import gaussian_kernel, jitter_convolve  # noqa: F401
from .render.regularizers import (  # noqa: F401
    curvature_gradient,
    normal_smoothing,
    total_area,
)
