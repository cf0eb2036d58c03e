"""Space carving from first-photon arrival times.

The JAX package's recon/carving.py in PyTorch (after the reference's
compute_space_carving_mesh.m:1-46): for every scan point, a voxel whose
round-trip distance 2*d1 is shorter than (first-photon distance - 10
bins) cannot be occupied; the carve region is the intersection over all
scan points.  ``carve_mesh`` extracts its boundary by marching tetrahedra
(or the height-field fast path), on the host in numpy, copied from the
JAX package; ``space_carving_projection`` lifts vertices onto it with the
port's nearest-hit query (rendering.py:193-206).

The occupancy is computed on the device of ``device`` as one broadcast
compare per chunk of scan points, the chunks ANDed together: separate
float32 operations, each root correctly rounded (``sqrt_rn``), so the card
and the CPU agree voxel for voxel.  The grids are jax 0.9's
``jnp.arange`` with a step at x64 off, which is NumPy's float32
``np.arange`` (``arange_f32``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry.intersect import nearest_hit
from ..geometry.mesh import Mesh, sqrt_rn

# float64 elements of the carve's largest temporary, [chunk, Z, Y, X]
_CARVE_ELEMENTS = 1 << 22


class CarveGrid(NamedTuple):
    occupancy: torch.Tensor  # [Z,Y,X] bool: True = possibly occupied
    xs: torch.Tensor         # [X] f32
    ys: torch.Tensor         # [Y] f32
    zs: torch.Tensor         # [Z] f32


def arange_f32(start: float, stop: float, step: float) -> np.ndarray:
    """``jnp.arange(start, stop, step)`` with x64 off, which jax 0.9 hands
    to NumPy with dtype float32."""
    return np.arange(start, stop, step, dtype=np.float32)


def carve_chunk(scan_points: int, voxels: int) -> int:
    """Scan points per broadcast compare: the [chunk, voxels] float64
    temporary stays within _CARVE_ELEMENTS."""
    return max(1, min(scan_points, _CARVE_ELEMENTS // max(voxels, 1)))


def _carve(first_distance, lighting, xs, ys, zs,
           threshold: float) -> torch.Tensor:
    """occupancy[z,y,x] = all_i (2*d1 > first_distance_i - threshold),
    d1 the distance from scan point i to voxel (xs[x], ys[y], zs[z])."""
    Z, Y, X = zs.shape[0], ys.shape[0], xs.shape[0]
    L = lighting.shape[0]
    chunk = carve_chunk(L, Z * Y * X)
    occ = torch.ones((Z, Y, X), dtype=torch.bool, device=xs.device)
    thr = first_distance - torch.tensor(threshold, dtype=torch.float32,
                                        device=xs.device)
    for s in range(0, L, chunk):
        light = lighting[s:s + chunk]
        dx = xs[None, :] - light[:, 0:1]
        dy = ys[None, :] - light[:, 1:2]
        dz = zs[None, :] - light[:, 2:3]
        d2 = ((dx * dx)[:, None, None, :] + (dy * dy)[:, None, :, None]) \
            + (dz * dz)[:, :, None, None]
        d1 = sqrt_rn(d2)
        occ &= (2.0 * d1 > thr[s:s + chunk, None, None, None]).all(dim=0)
    return occ


def first_photon_distance(transient, bin_width: float) -> torch.Tensor:
    """Path length of the first nonzero bin per scan point
    (compute_space_carving_mesh.m:18-20; 1-based bin index * bin_width),
    inf for a row with no nonzero bin."""
    t = torch.as_tensor(transient)
    nz = t != 0
    idx = torch.argmax(nz.to(torch.uint8), dim=1) + 1  # the first maximum
    dist = idx.to(torch.float32) * torch.tensor(bin_width, dtype=torch.float32,
                                               device=t.device)
    return torch.where(nz.any(dim=1), dist, float("inf"))


def space_carve_occupancy(transient, lighting, bin_width: float,
                          lateral: Tuple[float, float] = (-0.3, 0.3),
                          interval_x: float = 0.5 / 64,
                          z_max: Optional[float] = None,
                          threshold_bins: int = 10,
                          device="cuda") -> CarveGrid:
    """Carve the voxel grid (compute_space_carving_mesh.m:10-27) on
    ``device``: transient [L, B], lighting [L, 3]."""
    transient = torch.as_tensor(transient, dtype=torch.float32).to(device)
    lighting = torch.as_tensor(lighting, dtype=torch.float32).to(device)
    threshold = threshold_bins * bin_width
    if z_max is None:
        z_max = bin_width * transient.shape[1] / 2.0
    xs, zs = (torch.from_numpy(g).to(device) for g in (
        arange_f32(lateral[0], lateral[1] + interval_x / 2, interval_x),
        arange_f32(0.0, z_max + threshold / 4, threshold / 2.0)))
    fd = first_photon_distance(transient, bin_width)
    occ = _carve(fd, lighting, xs, xs, zs, threshold)
    return CarveGrid(occupancy=occ, xs=xs, ys=xs, zs=zs)


# 6-tetrahedra decomposition of a cube around the main diagonal v0-v6
# (corner numbering bit0=x, bit1=y, bit2=z); every tet contains the
# diagonal, so neighboring cubes share consistent face diagonals and the
# extracted surface is watertight.
_CUBE = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_TETS = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                  [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]])


def marching_tetrahedra(field: np.ndarray, xs, ys, zs, level: float = 0.5
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface triangle mesh of `field` [Z,Y,X] at `level` — the role of
    the reference's MATLAB MarchingCubes call
    (compute_space_carving_mesh.m:43-46), via the tetrahedral decomposition
    variant (table-free, watertight, handles overhangs/closed regions that
    a height field cannot represent).

    Vertices sit on grid edges at the linear-interpolation crossing
    (midpoints for a binary field); triangles are oriented with normals
    pointing toward field < level (outward from the occupied region)."""
    f = np.asarray(field, np.float64)
    Z, Y, X = f.shape
    gx, gy, gz = np.asarray(xs), np.asarray(ys), np.asarray(zs)
    # grid of corner coordinates [Z,Y,X,3] in (x, y, z) order
    coord = np.empty((Z, Y, X, 3))
    coord[..., 0] = gx[None, None, :]
    coord[..., 1] = gy[None, :, None]
    coord[..., 2] = gz[:, None, None]

    def flat(iz, iy, ix):
        return (iz * Y + iy) * X + ix

    cz, cy, cx = np.meshgrid(np.arange(Z - 1), np.arange(Y - 1),
                             np.arange(X - 1), indexing="ij")
    cz, cy, cx = cz.ravel(), cy.ravel(), cx.ravel()
    # global corner ids + field values per cube corner  [ncubes, 8]
    cid = np.stack([flat(cz + dz, cy + dy, cx + dx)
                    for dx, dy, dz in _CUBE], axis=1)
    fv = f.reshape(-1)[cid]
    inside = fv > level

    fflat = f.reshape(-1)
    cflat = coord.reshape(-1, 3)

    def edge_points(a_ids, b_ids):
        fa = fflat[a_ids]
        fb = fflat[b_ids]
        t = (level - fa) / np.where(fb != fa, fb - fa, 1.0)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return cflat[a_ids] * (1 - t) + cflat[b_ids] * t

    tri_keys = []     # [n, 3, 2] edge endpoint id pairs per triangle vertex
    tri_inside = []   # [n, 3] a point inside the region, for orientation
    for tet in _TETS:
        tc = cid[:, tet]                     # [nc, 4] corner ids
        ti = inside[:, tet]                  # [nc, 4] inside flags
        for pattern in range(1, 15):
            bits = [(pattern >> k) & 1 for k in range(4)]
            if sum(bits) in (0, 4):
                continue
            m = np.all(ti == np.array(bits, bool), axis=1)
            if not m.any():
                continue
            sel = tc[m]
            ins = [k for k in range(4) if bits[k]]
            outs = [k for k in range(4) if not bits[k]]
            if len(ins) == 1:                # tri on the 3 edges from A
                a = sel[:, ins[0]]
                es = [(a, sel[:, o]) for o in outs]
                tri_keys.append(np.stack(
                    [np.stack(e, 1) for e in es], 1))
                tri_inside.append(a)
            elif len(ins) == 3:              # tri on the 3 edges from D out
                d = sel[:, outs[0]]
                es = [(sel[:, i], d) for i in ins]
                tri_keys.append(np.stack(
                    [np.stack(e, 1) for e in es], 1))
                tri_inside.append(sel[:, ins[0]])
            else:                            # 2 in / 2 out: quad -> 2 tris
                a, b = sel[:, ins[0]], sel[:, ins[1]]
                c, d = sel[:, outs[0]], sel[:, outs[1]]
                e_ac = np.stack([a, c], 1)
                e_ad = np.stack([a, d], 1)
                e_bc = np.stack([b, c], 1)
                e_bd = np.stack([b, d], 1)
                tri_keys.append(np.stack([e_ac, e_ad, e_bd], 1))
                tri_inside.append(a)
                tri_keys.append(np.stack([e_ac, e_bd, e_bc], 1))
                tri_inside.append(a)
    if not tri_keys:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    keys = np.concatenate(tri_keys, axis=0)          # [T, 3, 2]
    ins_pt = cflat[np.concatenate(tri_inside)]       # [T, 3]
    keys_sorted = np.sort(keys, axis=2)
    uniq, vid = np.unique(keys_sorted.reshape(-1, 2), axis=0,
                          return_inverse=True)
    verts = edge_points(uniq[:, 0], uniq[:, 1]).astype(np.float32)
    faces = vid.reshape(-1, 3).astype(np.int32)

    # Merge coincident vertices BEFORE dropping degenerates: when field
    # values sit exactly at `level`, crossings on different edges can
    # interpolate to the same point; collapsing them first turns would-be
    # pinhole boundary edges into shared edges of the surviving faces.
    uniq_v, vmap = np.unique(verts, axis=0, return_inverse=True)
    verts = uniq_v
    faces = vmap[faces].astype(np.int32)
    # faces degenerate after the merge (repeated vertex ids) are exact
    # duplicates of an edge — drop them, and dedup faces sharing the same
    # vertex-id set
    nd = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[nd]
    ins_pt = ins_pt[nd]
    _, first = np.unique(np.sort(faces, axis=1), axis=0, return_index=True)
    faces = faces[np.sort(first)]
    ins_pt = ins_pt[np.sort(first)]

    # orient: normal away from the inside reference point
    p = verts[faces]
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    cen = p.mean(axis=1)
    flip = np.einsum("ij,ij->i", n, cen - ins_pt) < 0
    faces[flip] = faces[flip][:, ::-1]
    # drop remaining zero-area triangles (distinct but collinear vertices)
    keep = (np.linalg.norm(n, axis=1) > 1e-20)
    return verts, faces[keep]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def carve_mesh(grid: CarveGrid, method: str = "mc"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Boundary surface of the carve region, on the host.

    method='mc' (default): full isosurface via marching tetrahedra over the
    zero-padded occupancy — general occupancy (overhangs, closed cavities),
    parity with compute_space_carving_mesh.m:43-46.  The occupancy is
    padded with empty cells so regions touching the domain border close
    half a cell outside it.

    method='heightfield': legacy fast path — z_surf(y, x) = lowest occupied
    z per column, exactly the surface the +z projection rays hit when the
    carve region is a single slab."""
    occ = _host(grid.occupancy)             # [Z,Y,X]
    zs = _host(grid.zs)
    Z, Y, X = occ.shape
    if method == "mc":
        xs = _host(grid.xs)
        ys = _host(grid.ys)

        def pad_axis(c):
            c = np.asarray(c, np.float64)
            step0 = c[1] - c[0] if len(c) > 1 else 1.0
            return np.concatenate([[c[0] - step0], c, [c[-1] + step0]])

        fpad = np.zeros((Z + 2, Y + 2, X + 2))
        fpad[1:-1, 1:-1, 1:-1] = occ.astype(np.float64)
        return marching_tetrahedra(fpad, pad_axis(xs), pad_axis(ys),
                                   pad_axis(zs))
    any_occ = occ.any(axis=0)
    first = np.argmax(occ, axis=0)          # lowest occupied z index
    zsurf = np.where(any_occ, zs[first], zs[-1])
    gx, gy = np.meshgrid(_host(grid.xs), _host(grid.ys))
    v = np.stack([gx.ravel(), gy.ravel(), zsurf.ravel()], 1).astype(np.float32)
    faces = []
    for i in range(Y - 1):
        for j in range(X - 1):
            a = i * X + j
            faces.append([a, a + X, a + 1])
            faces.append([a + X, a + X + 1, a + 1])
    return v, np.asarray(faces, np.int32)


def space_carving_projection(v, carve: Mesh) -> torch.Tensor:
    """z := max(z, carve-surface z) per vertex (rendering.py:193-206):
    cast +z rays from (x, y, 0); vertices whose ray hits the carve mesh are
    raised to at least the hit depth.  On the carve mesh's device."""
    v = torch.as_tensor(v, dtype=carve.v.dtype).to(carve.device)
    o = v.clone()
    o[:, 2] = 0.0
    d = torch.zeros_like(v)
    d[:, 2] = 1.0
    fid, _, _, t = nearest_hit(o, d, carve.v, carve.f, carve.f_valid)
    newz = torch.where(fid >= 0, torch.maximum(t, v[:, 2]), v[:, 2])
    out = v.clone()
    out[:, 2] = newz
    return out
