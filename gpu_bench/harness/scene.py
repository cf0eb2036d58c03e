"""The benchmark's inputs, made from the seed: the stand-in surfaces, the
confocal scan and the sampling key.  The program receives only these."""

from __future__ import annotations

import numpy as np

from gpu_bench.reference.geometry import morton_order_faces
from gpu_bench.reference.sampler import key  # noqa: F401  (the inputs' key)


def grid_faces(n: int) -> np.ndarray:
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            f.append([a, a + n, a + 1])
            f.append([a + n, a + n + 1, a + 1])
    return np.array(f, np.int32)


def height_field(n, extent, z0, amplitude, noise, seed):
    """(v [n*n, 3] f32, Morton-ordered faces, flat plane at z0): the bumpy
    height field z0 + amplitude*sin(6x)cos(5y) + noise*N(0, 1), the
    noise drawn from RandomState(seed mod 2^32)."""
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    z = z0 + amplitude * np.sin(6 * gx) * np.cos(5 * gy)
    if noise:
        z = z + noise * np.random.RandomState(seed % (1 << 32)).randn(n, n)
    v = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    plane = v.copy()
    plane[:, 2] = z0
    return v, morton_order_faces(v, grid_faces(n)), plane


def confocal_scan(resolution, lower, upper, wall_z=0.0):
    """(lighting [L, 3], normals [L, 3]) f32 on the wall, x fastest."""
    xs = np.linspace(lower[0], upper[0], resolution)
    ys = np.linspace(lower[1], upper[1], resolution)
    gx, gy = np.meshgrid(xs, ys)
    lit = np.stack([gx.ravel(), gy.ravel(),
                    np.full(resolution * resolution, wall_z)], 1)
    nrm = np.tile(np.array([0.0, 0.0, 1.0]), (lit.shape[0], 1))
    return (np.ascontiguousarray(lit, np.float32),
            np.ascontiguousarray(nrm, np.float32))


def source_chunk(chunk: int, faces: int, samples: int, cap: int) -> int:
    """The deployment's source chunk halved while a chunk holds more than
    ``cap`` rays (the outer loop's rule)."""
    spt = 1 + (samples - 1) // max(faces, 1)
    limit = max(1, cap // (faces * spt))
    while chunk > limit:
        chunk //= 2
    return max(chunk, 1)
