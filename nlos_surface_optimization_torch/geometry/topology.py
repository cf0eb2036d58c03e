"""Host-side mesh topology (numpy): adjacency, borders, components, culling.

Copied from the JAX package's numpy-only topology module, so that this
package needs nothing of it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _edge_key(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Canonical (undirected) edge keys as int64."""
    lo = np.minimum(a, b).astype(np.int64)
    hi = np.maximum(a, b).astype(np.int64)
    return lo << 32 | hi


def face_affinity(f: np.ndarray) -> np.ndarray:
    """[F,3] neighbor face across each edge (f[k], f[k+1 mod 3]); -1 if the
    edge is a border (or non-manifold with no unique partner)."""
    f = np.asarray(f, np.int64)
    F = f.shape[0]
    keys = np.stack([
        _edge_key(f[:, 0], f[:, 1]),
        _edge_key(f[:, 1], f[:, 2]),
        _edge_key(f[:, 2], f[:, 0]),
    ], axis=1).reshape(-1)                    # [3F] edge per (face, slot)
    owner = np.repeat(np.arange(F), 3)
    order = np.argsort(keys, kind="stable")
    sk, so = keys[order], owner[order]
    out = -np.ones(3 * F, np.int32)
    # equal keys are adjacent after sort; a manifold interior edge is a run
    # of exactly 2 — pair those two slots, leave borders/non-manifold at -1
    eq_prev = np.empty(len(sk), bool)
    eq_prev[0] = False
    eq_prev[1:] = sk[1:] == sk[:-1]
    out_sorted = -np.ones(len(sk), np.int32)
    run_start = np.where(~eq_prev)[0]
    run_len = np.diff(np.append(run_start, len(sk)))
    two = run_start[run_len == 2]
    out_sorted[two] = so[two + 1]
    out_sorted[two + 1] = so[two]
    out[order] = out_sorted
    return out.reshape(F, 3).astype(np.int32)


def border_vertices(f: np.ndarray, num_vertices: int) -> np.ndarray:
    """[V] int32 indicator: 1 where the vertex lies on a border edge
    (an edge referenced by exactly one face)."""
    f = np.asarray(f, np.int64)
    e = np.stack([
        np.stack([f[:, 0], f[:, 1]], 1),
        np.stack([f[:, 1], f[:, 2]], 1),
        np.stack([f[:, 2], f[:, 0]], 1),
    ], axis=1).reshape(-1, 2)
    keys = _edge_key(e[:, 0], e[:, 1])
    uniq, counts = np.unique(keys, return_counts=True)
    ind = np.zeros(num_vertices, np.int32)
    mask = np.isin(keys, uniq[counts == 1])
    ind[np.unique(e[mask].reshape(-1))] = 1
    return ind


def connected_components(f: np.ndarray, num_vertices: int) -> np.ndarray:
    """[V] component label per vertex (union-find over face edges)."""
    parent = np.arange(num_vertices)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for tri in np.asarray(f):
        a, b, c = (int(t) for t in tri)
        ra, rb, rc = find(a), find(b), find(c)
        parent[ra] = rb = find(rb)
        parent[find(rc)] = find(rb)
    return np.array([find(i) for i in range(num_vertices)])


def keep_largest_component(v: np.ndarray, f: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep faces of the component with the most faces
    (cgal keep_largest_connected_components semantics), then drop
    unreferenced vertices."""
    labels = connected_components(f, v.shape[0])
    fl = labels[f[:, 0]]
    uniq, counts = np.unique(fl, return_counts=True)
    keep_label = uniq[np.argmax(counts)]
    f2 = f[fl == keep_label]
    return remove_unreferenced(v, f2)


def remove_unreferenced(v: np.ndarray, f: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    used = np.unique(f.reshape(-1))
    remap = -np.ones(v.shape[0], np.int64)
    remap[used] = np.arange(len(used))
    return v[used], remap[f].astype(np.int32)


def convex_hull_2d(points: np.ndarray) -> np.ndarray:
    """Indices of the 2-D convex hull in counter-clockwise order (Andrew
    monotone chain) — cgal_api.find_convex_hull equivalent
    (c_cgal_api.cpp:250+)."""
    pts = np.asarray(points)[:, :2]
    order = np.lexsort((pts[:, 1], pts[:, 0]))

    def cross2(u, w):
        return u[0] * w[1] - u[1] * w[0]

    def half(indices):
        out = []
        for i in indices:
            while len(out) >= 2:
                o, a = pts[out[-2]], pts[out[-1]]
                if cross2(a - o, pts[i] - o) <= 0:
                    out.pop()
                else:
                    break
            out.append(i)
        return out

    lower = half(order)
    upper = half(order[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def remove_triangles(f: np.ndarray, affinity: np.ndarray,
                     intensity: np.ndarray, threshold: float = 0.0
                     ) -> np.ndarray:
    """Keep mask for removeTriangle (rendering.py:271-278): a face survives
    if its rendered intensity exceeds the threshold OR it has all 3 edge
    neighbors (interior faces are never culled)."""
    interior = np.sum(affinity < 0, axis=1) == 0
    return (intensity > threshold) | interior
