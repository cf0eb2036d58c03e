"""Mesh quantities for the reference: face order, adjacency, borders,
normals and areas, at the reference's precision."""

from __future__ import annotations

import numpy as np
import torch


def _morton3(x: np.ndarray, bits: int = 10) -> np.ndarray:
    def part(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    q = np.clip((x * (2 ** bits - 1)).astype(np.int64), 0, 2 ** bits - 1)
    return (part(q[:, 0]) | (part(q[:, 1]) << np.uint64(1))
            | (part(q[:, 2]) << np.uint64(2)))


def morton_order_faces(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Faces reordered by the Morton code of their centroids (stable), in
    the float32 steps of the deployment's GT set-up."""
    v = np.asarray(v)
    f = np.asarray(f)
    if f.shape[0] < 2:
        return f
    cent = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3.0
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    return f[np.argsort(_morton3((cent - lo) / span), kind="stable")]


def _edge_key(a, b):
    lo = np.minimum(a, b).astype(np.int64)
    hi = np.maximum(a, b).astype(np.int64)
    return lo << 32 | hi


def face_affinity(f: np.ndarray) -> np.ndarray:
    """[F, 3] the face across edge (f[k], f[k+1]), -1 on a border or a
    non-manifold edge."""
    f = np.asarray(f, np.int64)
    F = f.shape[0]
    keys = np.stack([_edge_key(f[:, k], f[:, (k + 1) % 3])
                     for k in range(3)], axis=1).reshape(-1)
    owner = np.repeat(np.arange(F), 3)
    order = np.argsort(keys, kind="stable")
    sk, so = keys[order], owner[order]
    out = -np.ones(3 * F, np.int64)
    first = np.ones(len(sk), bool)
    first[1:] = sk[1:] != sk[:-1]
    start = np.flatnonzero(first)
    length = np.diff(np.append(start, len(sk)))
    two = start[length == 2]
    out_sorted = -np.ones(len(sk), np.int64)
    out_sorted[two] = so[two + 1]
    out_sorted[two + 1] = so[two]
    out[order] = out_sorted
    return out.reshape(F, 3)


def border_vertices(f: np.ndarray, num_vertices: int) -> np.ndarray:
    """[V] bool: the vertex lies on an edge that one face alone holds."""
    f = np.asarray(f, np.int64)
    e = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], 1).reshape(-1, 2)
    keys = _edge_key(e[:, 0], e[:, 1])
    uniq, counts = np.unique(keys, return_counts=True)
    on = np.isin(keys, uniq[counts == 1])
    out = np.zeros(num_vertices, bool)
    out[e[on].reshape(-1)] = True
    return out


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def dot(a, b):
    return (a * b).sum(-1)


def normals_areas(v: torch.Tensor, f: torch.Tensor):
    """Unit face normals [F, 3] (zero for a degenerate face), areas [F]."""
    p1, p2, p3 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = cross(p2 - p1, p3 - p1)
    dbl = torch.sqrt(dot(n, n))
    return n / torch.clamp(dbl, min=1e-30)[:, None], dbl / 2


def vertex_normals(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, unit length."""
    n, area = normals_areas(v, f)
    acc = torch.zeros_like(v)
    for k in range(3):
        acc.index_add_(0, f[:, k], n * area[:, None])
    return acc / torch.clamp(torch.sqrt(dot(acc, acc)), min=1e-30)[:, None]


def _segment_dist2(p, a, b):
    ab = b - a
    tiny = torch.finfo(ab.dtype).tiny
    h = torch.clamp(dot(p - a, ab) / torch.clamp(dot(ab, ab), min=tiny),
                    0.0, 1.0)
    d = p - a - h[..., None] * ab
    return dot(d, d)


def point_mesh_distance(points: torch.Tensor, v: torch.Tensor,
                        f: torch.Tensor, batch: int = 256) -> torch.Tensor:
    """Unsigned distance [P] from each point to the nearest triangle: the
    distance to its plane where the point projects inside it, else to
    the nearest of its three edges (a degenerate triangle: its edges)."""
    a, b, c = (v[f[:, k]][None] for k in range(3))          # [1, F, 3]
    n = cross(b - a, c - a)
    nn = dot(n, n)
    safe = torch.clamp(nn, min=torch.finfo(nn.dtype).tiny)
    out = []
    for p0 in range(0, points.shape[0], batch):
        p = points[p0:p0 + batch, None, :]                   # [P, 1, 3]
        h = dot(p - a, n)
        q = p - (h / safe)[..., None] * n
        inside = (nn > 0) & (dot(cross(b - a, q - a), n) >= 0) & (
            dot(cross(c - b, q - b), n) >= 0) & (
            dot(cross(a - c, q - c), n) >= 0)
        edge = torch.minimum(torch.minimum(_segment_dist2(p, a, b),
                                           _segment_dist2(p, b, c)),
                             _segment_dist2(p, c, a))
        plane = h * h / safe
        d2 = torch.where(inside, torch.minimum(plane, edge), edge)
        out.append(torch.sqrt(d2.amin(dim=1)))
    return torch.cat(out)
