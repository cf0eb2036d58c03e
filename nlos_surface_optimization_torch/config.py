"""Render configuration (a numpy-only copy of the JAX package's config).

``RenderConfig`` is a frozen, hashable dataclass with the same fields and
defaults as ``nlos_surface_optimization_tpu.config.RenderConfig``, so a
config can be carried across with ``convert.config_from_fields``.  The two
backend switches keep their values; what they select here:

  occl_backend  'auto' / 'fused'  fused occlusion + splat (render/fused_kernels:
                                  the CUDA kernel for CUDA tensors, its plain
                                  PyTorch version for CPU tensors)
                'jnp'             the eager tiled Möller–Trumbore path
                                  (render/core.trace_chunk + forward_chunk)
                'pallas', 'mxu'   TPU-only; NotImplementedError
  bwd_backend   'auto' / 'fused'  fused per-face backward (render/bwd_kernels,
                                  kernel on CUDA, plain version on CPU)
                'xla'             the eager render/core.backward_chunk
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

OCCL_BACKENDS = ("auto", "fused", "jnp")
BWD_BACKENDS = ("auto", "fused", "xla")
_TPU_ONLY = ("pallas", "mxu")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static renderer options; field semantics as in the JAX package."""

    # per-face sample count is 1 + (num_samples - 1) // num_faces
    num_samples: int = 2500

    # B bins of width distance_resolution metres of path length
    num_bins: int = 1200
    distance_resolution: float = 1.2e-3
    bin_lower: float = 0.0

    # Gaussian temporal smoothing: sigma = resolution*sigma_bin/2.355 over
    # 4*refine*sigma_bin+1 sub-bins; the forward only smooths when
    # sigma_bin >= 5 (forward_refine)
    bin_refine_resolution: int = 10
    sigma_bin: int = 1

    # shading normal: 'fn' face normals or 'vn' interpolated vertex normals
    normal: str = "fn"
    # gates the normal-derivative gradient term in vn mode
    testing_flag: int = 1
    # loss_flag == 1 maps the difference d -> 2*d^3 before weighting
    loss_flag: int = 0
    # 'lambertian'; 'ggx' is not ported yet
    brdf: str = "lambertian"

    occl_t_rel: float = 1e-4
    occl_t_min: float = 1e-6
    ggx_compat_dx: bool = False
    # legacy box smoothing of the difference (0 = off, the production path)
    loss_smooth_width: int = 0
    # sources rendered per chunk (0 = all in one chunk)
    source_chunk: int = 0

    occl_backend: str = "auto"
    bwd_backend: str = "auto"

    @property
    def bin_upper(self) -> float:
        return self.bin_lower + self.num_bins * self.distance_resolution

    @property
    def sigma(self) -> float:
        return self.distance_resolution * self.sigma_bin / 2.355

    @property
    def kernel_taps(self) -> int:
        return 4 * self.bin_refine_resolution * self.sigma_bin + 1

    @property
    def forward_refine(self) -> int:
        """Refine scale used by the forward pass (1 unless sigma_bin >= 5)."""
        return 1 if self.sigma_bin < 5 else self.bin_refine_resolution

    def samples_per_face(self, num_faces: int) -> int:
        return 1 + (self.num_samples - 1) // max(num_faces, 1)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def check_backends(cfg: RenderConfig) -> None:
    """Raise on backend values this package does not implement."""
    for field, known in (("occl_backend", OCCL_BACKENDS),
                         ("bwd_backend", BWD_BACKENDS)):
        value = getattr(cfg, field)
        if value in _TPU_ONLY:
            raise NotImplementedError(
                f"{field}={value!r} is a TPU backend; use one of {known}")
        if value not in known:
            raise ValueError(f"unknown {field} {value!r}")
    if cfg.brdf != "lambertian":
        raise NotImplementedError(f"brdf={cfg.brdf!r} is not ported yet")


def make_confocal_scan(
    resolution: int,
    lower: Tuple[float, float] = (-0.25, -0.25),
    upper: Tuple[float, float] = (0.25, 0.25),
    wall_z: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Confocal scan grid on the wall: (lighting [L,3] f32, normals [L,3] f32),
    L = res^2, row-major with x varying fastest."""
    xs = np.linspace(lower[0], upper[0], resolution)
    ys = np.linspace(lower[1], upper[1], resolution)
    gx, gy = np.meshgrid(xs, ys)
    lighting = np.stack(
        [gx.reshape(-1), gy.reshape(-1), np.full(resolution * resolution, wall_z)],
        axis=1,
    ).astype(np.float32)
    normal = np.tile(np.array([0.0, 0.0, 1.0], dtype=np.float32), (lighting.shape[0], 1))
    return np.ascontiguousarray(lighting), np.ascontiguousarray(normal)


def num_bins_for(lower: float, upper: float, resolution: float) -> int:
    """B = ceil((upper-lower)/resolution)."""
    return int(math.ceil((upper - lower) / resolution))
