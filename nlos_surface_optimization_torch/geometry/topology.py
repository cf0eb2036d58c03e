"""Host-side mesh topology (numpy): edge adjacency and border vertices.

Copied from the JAX package's numpy-only topology module, so that this
package needs nothing of it.
"""

from __future__ import annotations

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
