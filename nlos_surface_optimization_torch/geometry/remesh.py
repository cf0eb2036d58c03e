"""Incremental isotropic remeshing (Botsch-Kobbelt) + vertex integration.

A numpy copy of the JAX package's geometry/remesh.py; the one change is
that integrate_vertices' fallback (no geomlib) runs this package's
Möller–Trumbore on float64 CPU tensors.

Replaces the reference's CGAL PMP::isotropic_remeshing binding
(cgal_api/c_cgal_api.cpp:198-249: border-edge split + protect, nb_iter
sweeps) and stands in for El Topo's remesh/integrate pair
(el_topo_api/c_el_topo_api.cpp:10-101) in the outer loop.  Host-side: mesh
surgery is combinatorial, tiny next to rendering, and runs between jitted
steps exactly where the reference calls its native libraries from Python.

Algorithm per sweep (Botsch & Kobbelt, "A Remeshing Approach to
Multiresolution Modeling", SGP 2004 — the same scheme CGAL implements):
  1. split edges longer than 4/3 * target at their midpoint
  2. collapse edges shorter than 4/5 * target (midpoint; border protected)
  3. flip edges to equalize vertex valences
  4. tangential relaxation of interior vertices

A C++ port of this module (geomlib/) is the plan-of-record for large
meshes; this implementation defines the semantics and the tests.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .topology import border_vertices


def _edges_of(f: np.ndarray):
    """Iterate (a, b, face_idx, slot) over directed edges."""
    for i, tri in enumerate(f):
        yield tri[0], tri[1], i, 0
        yield tri[1], tri[2], i, 1
        yield tri[2], tri[0], i, 2


def _undirected_edge_map(f: np.ndarray) -> Dict[Tuple[int, int], List[int]]:
    em: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for a, b, i, _ in _edges_of(f):
        em[(min(a, b), max(a, b))].append(i)
    return em


def _split_long_edges(v: List[np.ndarray], f: np.ndarray, high: float
                      ) -> np.ndarray:
    """One sweep of longest-edge midpoint splits.  Faces with a long edge
    are split at their LONGEST long edge; both faces sharing that edge are
    rebuilt.  Repeats internally until no edge exceeds `high`."""
    f = f.tolist()
    changed = True
    guard = 0
    while changed and guard < 50:
        guard += 1
        changed = False
        em: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
        for idx, tri in enumerate(f):
            for s in range(3):
                a, b = tri[s], tri[(s + 1) % 3]
                em[(min(a, b), max(a, b))].append((idx, s))
        # longest-first so each split round attacks the worst edges
        long_edges = []
        for (a, b), uses in em.items():
            L = float(np.linalg.norm(v[a] - v[b]))
            if L > high:
                long_edges.append((L, a, b, uses))
        if not long_edges:
            break
        long_edges.sort(reverse=True)
        dead: Set[int] = set()
        new_faces: List[List[int]] = []
        for L, a, b, uses in long_edges:
            if any(u[0] in dead for u in uses):
                continue  # face already rebuilt this round
            mid = len(v)
            v.append((v[a] + v[b]) / 2.0)
            for idx, s in uses:
                tri = f[idx]
                c = tri[(s + 2) % 3]
                ta, tb = tri[s], tri[(s + 1) % 3]
                dead.add(idx)
                new_faces.append([ta, mid, c])
                new_faces.append([mid, tb, c])
            changed = True
        f = [tri for i, tri in enumerate(f) if i not in dead] + new_faces
    return np.asarray(f, np.int64).reshape(-1, 3)


def _collapse_short_edges(v: List[np.ndarray], f: np.ndarray, low: float,
                          high: float, protect: np.ndarray) -> np.ndarray:
    """Collapse edges shorter than `low` to their midpoint when the result
    creates no edge longer than `high`; vertices in `protect` (borders) are
    never moved or removed.

    Collision-safe (El Topo runs its collision pipeline per remesh
    operation, c_el_topo_api.cpp:22-44): collapses are selected as a
    vertex-disjoint batch, the joint motion (both endpoints -> target) is
    run through FULL swept CCD on the current topology, and only collapses
    whose endpoints actually reached the target are merged.  A collapse
    drags every incident face, so per-candidate path tests are not enough —
    only swept vertex-face + edge-edge CCD catches a dragged face sweeping
    through an opposing sheet (tests/test_self_collision.py)."""
    V = len(v)
    # vertex -> neighbor set, vertex -> incident faces
    nbr: List[Set[int]] = [set() for _ in range(V)]
    finc: List[List[int]] = [[] for _ in range(V)]
    for i, tri in enumerate(f):
        for k in range(3):
            finc[int(tri[k])].append(i)
    for a, b, _, _ in _edges_of(f):
        nbr[a].add(b)
        nbr[b].add(a)
    parent = np.arange(V)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cands = []
    for (a, b) in _undirected_edge_map(f).keys():
        if protect[a] and protect[b]:
            continue
        L = float(np.linalg.norm(v[a] - v[b]))
        if L < low:
            cands.append((L, a, b))
    cands.sort()

    used = np.zeros(V, bool)
    accepted = []  # (keep, drop, pos)
    for L, a, b in cands:
        if used[a] or used[b]:
            continue
        if protect[a]:
            keep, drop, pos = a, b, v[a]
        elif protect[b]:
            keep, drop, pos = b, a, v[b]
        else:
            keep, drop, pos = a, b, (v[a] + v[b]) / 2.0
        merged = (nbr[a] | nbr[b]) - {a, b}
        if any(np.linalg.norm(pos - v[m]) > high for m in merged):
            continue
        # link condition (simplified): <= 2 shared neighbors
        if len((nbr[a] & nbr[b]) - {a, b}) > 2:
            continue
        # local manifoldness after the remap (geomlib remesh.cpp:312-345):
        # simulate the merge over the incident faces; reject on any
        # duplicate directed edge or >2-face undirected edge.  The link
        # condition alone misses this when a and b were joined through an
        # earlier zipper merge.
        loc = sorted(set(finc[a]) | set(finc[b]))
        dirE: Set[Tuple[int, int]] = set()
        undC: Dict[Tuple[int, int], int] = defaultdict(int)
        bad2 = False
        for fi in loc:
            tri = f[fi]
            if any((tri[s] == a and tri[(s + 1) % 3] == b)
                   or (tri[s] == b and tri[(s + 1) % 3] == a)
                   for s in range(3)):
                continue  # face dies with the edge
            r2 = [keep if int(x) in (a, b) else int(x) for x in tri]
            for s in range(3):
                p, q = r2[s], r2[(s + 1) % 3]
                if (p, q) in dirE:
                    bad2 = True
                    break
                dirE.add((p, q))
                undC[(min(p, q), max(p, q))] += 1
                if undC[(min(p, q), max(p, q))] > 2:
                    bad2 = True
                    break
            if bad2:
                break
        if bad2:
            continue
        used[a] = used[b] = True
        accepted.append((keep, drop, np.asarray(pos, np.float64)))

    if accepted:
        # Iterate the batch CCD: a rejected collapse reverts to its STATIC
        # original position, changing the motion the remaining accepted set
        # must clear, so re-test the accepted-only proposal until stable.
        before = np.asarray(v, np.float64)
        tol = 1e-9 * low + 1e-14
        ok = [True] * len(accepted)
        for _ in range(8):
            proposed = before.copy()
            rep = np.arange(before.shape[0], dtype=np.int32)
            for flag, (keep, drop, pos) in zip(ok, accepted):
                if flag:
                    proposed[keep] = pos
                    proposed[drop] = pos
                    rep[drop] = keep
            safe = np.asarray(
                integrate_vertices(before, np.asarray(f, np.int32), proposed,
                                   rep=rep),
                np.float64,
            )
            changed = False
            for k, (keep, drop, pos) in enumerate(accepted):
                if not ok[k]:
                    continue
                if (np.linalg.norm(safe[keep] - pos) > tol
                        or np.linalg.norm(safe[drop] - pos) > tol):
                    ok[k] = False
                    changed = True
            if not changed:
                break
        # Global post-remap manifoldness: the JOINT remap of the batch can
        # create duplicate directed / >2-face edges no single candidate
        # shows (two disjoint collapses pinching one quad); iteratively
        # reject collapses whose kept vertex touches a violating edge.
        for _ in range(8):
            r = np.arange(before.shape[0])
            for flag, (keep, drop, pos) in zip(ok, accepted):
                if flag:
                    r[drop] = keep
            fr = r[np.asarray(f, np.int64)]
            live = ((fr[:, 0] != fr[:, 1]) & (fr[:, 1] != fr[:, 2])
                    & (fr[:, 0] != fr[:, 2]))
            from collections import Counter
            dirE: Counter = Counter()
            undE: Counter = Counter()
            for t in fr[live]:
                for s in range(3):
                    p, q = int(t[s]), int(t[(s + 1) % 3])
                    dirE[(p, q)] += 1
                    undE[(min(p, q), max(p, q))] += 1
            badv = set()
            for (p, q), c in dirE.items():
                if c > 1:
                    badv.update((p, q))
            for (p, q), c in undE.items():
                if c > 2:
                    badv.update((p, q))
            if not badv:
                break
            changed = False
            for k, (keep, drop, pos) in enumerate(accepted):
                if ok[k] and int(r[keep]) in badv:
                    ok[k] = False
                    changed = True
            if not changed:
                break  # violations pre-date this batch
        for flag, (keep, drop, pos) in zip(ok, accepted):
            if flag:
                v[keep] = pos
                parent[drop] = keep

    out = []
    for tri in f:
        t = [find(int(x)) for x in tri]
        if len(set(t)) == 3:
            out.append(t)
    return np.asarray(out, np.int64).reshape(-1, 3)


def _segment_hits_any(varr: np.ndarray, f: np.ndarray, o, q,
                      exclude: Set[int]) -> bool:
    """True when segment o->q crosses a face none of whose vertices is in
    `exclude` (strictly interior hit)."""
    keep = ~np.isin(np.asarray(f), list(exclude)).any(axis=1)
    if not keep.any():
        return False
    tri = np.asarray(f)[keep]
    p1 = varr[tri[:, 0]]
    e1 = varr[tri[:, 1]] - p1
    e2 = varr[tri[:, 2]] - p1
    d = np.asarray(q, np.float64) - np.asarray(o, np.float64)
    pv = np.cross(np.broadcast_to(d, e2.shape), e2)
    det = np.einsum("ij,ij->i", e1, pv)
    ok = np.abs(det) > 1e-18
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = np.asarray(o, np.float64) - p1
    u = np.einsum("ij,ij->i", tv, pv) * inv
    qv = np.cross(tv, e1)
    w = np.einsum("j,ij->i", d, qv) * inv
    t = np.einsum("ij,ij->i", e2, qv) * inv
    return bool((ok & (u >= 0) & (w >= 0) & (u + w <= 1)
                 & (t > 1e-12) & (t < 1 - 1e-12)).any())


def _flip_edges(v: List[np.ndarray], f: np.ndarray, protect: np.ndarray
                ) -> np.ndarray:
    """Flip interior edges when it reduces total squared valence deviation
    (target valence 6 interior / 4 border) and keeps triangles valid."""
    f = f.copy()
    valence = np.zeros(len(v), np.int64)
    for a, b, _, _ in _edges_of(f):
        valence[a] += 1  # each directed edge once => counts degree
    target = np.where(protect[: len(v)] == 1, 4, 6)

    em: Dict[Tuple[int, int], List[Tuple[int, int]]] = defaultdict(list)
    for idx, tri in enumerate(f):
        for s in range(3):
            a, b = tri[s], tri[(s + 1) % 3]
            em[(min(a, b), max(a, b))].append((idx, s))

    touched: Set[int] = set()
    new_diag: Set[Tuple[int, int]] = set()
    for _, uses in em.items():
        if len(uses) != 2:
            continue
        (i1, s1), (i2, s2) = uses
        if i1 in touched or i2 in touched:
            continue
        # direction from face i1 (the em key is sorted, not oriented)
        a = f[i1][s1]
        b = f[i1][(s1 + 1) % 3]
        c = f[i1][(s1 + 2) % 3]
        d = f[i2][(s2 + 2) % 3]
        if c == d:
            continue
        diag = (min(c, d), max(c, d))
        # duplicate-edge guard: the diagonal must exist neither in the
        # pre-sweep mesh NOR among diagonals created earlier THIS sweep
        # (two quads sharing opposite corners flipping onto the same
        # diagonal would make a >2-face edge); mirrors geomlib flip_edges
        if diag in em or diag in new_diag:
            continue
        def dev(val, i):
            return (val - target[i]) ** 2
        before = (dev(valence[a], a) + dev(valence[b], b)
                  + dev(valence[c], c) + dev(valence[d], d))
        after = (dev(valence[a] - 1, a) + dev(valence[b] - 1, b)
                 + dev(valence[c] + 1, c) + dev(valence[d] + 1, d))
        if after >= before:
            continue
        # geometric sanity: new triangles must be non-degenerate
        n1 = np.cross(v[d] - v[c], v[a] - v[c])
        n2 = np.cross(v[b] - v[c], v[d] - v[c])
        if np.linalg.norm(n1) < 1e-14 or np.linalg.norm(n2) < 1e-14:
            continue
        if np.dot(n1, n2) <= 0:
            continue  # would fold
        # collision guard: the flip rebuilds the quad's surface, so reject
        # it when the new diagonal crosses a face not touching the quad
        # (geomlib's flip_edges applies the same test)
        if _segment_hits_any(np.asarray(v), f, v[c], v[d], {a, b, c, d}):
            continue
        # winding: keep f1's outer directed edges (b->c, c->a) and f2's
        # (a->d, d->b); the new diagonal is shared anti-parallel
        f[i1] = [a, d, c]
        f[i2] = [b, c, d]
        valence[a] -= 1
        valence[b] -= 1
        valence[c] += 1
        valence[d] += 1
        touched.add(i1)
        touched.add(i2)
        new_diag.add(diag)
    return f


def _tangential_relax(v: np.ndarray, f: np.ndarray, protect: np.ndarray,
                      lam: float = 0.5) -> np.ndarray:
    """Move interior vertices toward their neighbor centroid, projected
    onto the tangent plane of the (area-weighted) vertex normal."""
    V = v.shape[0]
    acc = np.zeros_like(v)
    cnt = np.zeros(V)
    for a, b, _, _ in _edges_of(f):
        acc[a] += v[b]
        cnt[a] += 1
    cnt = np.maximum(cnt, 1)
    centroid = acc / cnt[:, None]

    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], n)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = vn / np.maximum(norm, 1e-30)

    d = centroid - v
    d = d - vn * np.sum(d * vn, axis=1, keepdims=True)
    out = v + lam * d
    out[protect == 1] = v[protect == 1]
    return out


def _cleanup_faces(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Drop zero-area faces and duplicate faces (same vertex set)."""
    if f.shape[0] == 0:
        return f
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    ok = np.linalg.norm(n, axis=1) > 1e-14
    f = f[ok]
    seen: Set[Tuple[int, int, int]] = set()
    out = []
    for tri in f:
        key = tuple(sorted(int(x) for x in tri))
        if key in seen:
            continue
        seen.add(key)
        out.append(tri)
    return np.asarray(out, f.dtype).reshape(-1, 3)


def isotropic_remesh(v: np.ndarray, f: np.ndarray, target_edge_length: float,
                     iterations: int = 3, protect_border: bool = True,
                     backend: str = "auto"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """CGAL-equivalent isotropic remeshing (c_cgal_api.cpp:198-249;
    nb_iter=3 as rendering.py:83).

    backend: 'auto' uses the C++ geomlib when built (18-30x faster),
    'native' requires it, 'python' forces this module's implementation."""
    if backend in ("auto", "native"):
        try:
            from .native import isotropic_remesh_native
            return isotropic_remesh_native(
                v, f, target_edge_length, iterations, protect_border
            )
        except Exception:
            if backend == "native":
                raise
    return isotropic_remesh_py(v, f, target_edge_length, iterations,
                               protect_border)


def el_topo_remesh(v: np.ndarray, f: np.ndarray, target_edge_length: float,
                   iterations: int = 1, merge_eps: float = None,
                   max_volume_change: float = 0.01,
                   protect_border: bool = True):
    """El Topo static-operations parity (el_topo_api.pyx / c_el_topo_api.cpp
    :10-74): remesh with TOPOLOGY CHANGES enabled — surface patches that
    approach within merge_eps (default edge_length/10, :40) are zippered
    into one sheet — plus the per-operation volume-change cap
    m_max_volume_change (:30, reference value 0.01).

    Returns (v, f, num_merges).  Requires the C++ geomlib (the zipper +
    CCD pipeline is native); falls back to merge-free isotropic remeshing
    with num_merges = 0 when the library is unavailable."""
    try:
        from .native import topo_remesh_native
        return topo_remesh_native(v, f, target_edge_length, iterations,
                                  merge_eps, max_volume_change,
                                  protect_border)
    except Exception:
        nv, nf = isotropic_remesh_py(v, f, target_edge_length, iterations,
                                     protect_border)
        return nv, nf, 0


def isotropic_remesh_py(v: np.ndarray, f: np.ndarray,
                        target_edge_length: float, iterations: int = 3,
                        protect_border: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-Python reference implementation (semantics twin of geomlib)."""
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64)
    high = 4.0 / 3.0 * target_edge_length
    low = 4.0 / 5.0 * target_edge_length
    for _ in range(iterations):
        vlist = [v[i].copy() for i in range(v.shape[0])]
        f = _split_long_edges(vlist, f, high)
        protect = border_vertices(f.astype(np.int32), len(vlist)) \
            if protect_border else np.zeros(len(vlist), np.int32)
        f = _collapse_short_edges(vlist, f, low, high, protect)
        v = np.asarray(vlist)
        f = _cleanup_faces(v, f)
        # drop unreferenced vertices, remap
        used = np.unique(f)
        remap = -np.ones(v.shape[0], np.int64)
        remap[used] = np.arange(len(used))
        v = v[used]
        f = remap[f]
        protect = border_vertices(f.astype(np.int32), v.shape[0]) \
            if protect_border else np.zeros(v.shape[0], np.int32)
        vlist = [v[i].copy() for i in range(v.shape[0])]
        f = _flip_edges(vlist, f, protect)
        before = np.asarray(vlist)
        relaxed = _tangential_relax(before, f, protect)
        # CCD-guard the relaxation: split/collapse/flip keep vertices on
        # the existing surface, but relaxation moves them off it and can
        # fold a surface in contact through itself (El Topo's remesher is
        # collision-safe per operation; tests/test_self_collision.py).
        v = np.asarray(
            integrate_vertices(before, f.astype(np.int32), relaxed),
            np.float64,
        )
    return v.astype(np.float32), f.astype(np.int32)


def integrate_vertices(old_v: np.ndarray, f: np.ndarray, new_v: np.ndarray,
                       collision_aware: bool = True,
                       rep: np.ndarray = None) -> np.ndarray:
    """Apply a proposed vertex update (El Topo el_topo_integrate dt=1,
    c_el_topo_api.cpp:75-101).

    Preferred path: full continuous collision detection in native geomlib
    (vertex-triangle + edge-edge first-contact cubics, the El Topo /
    Bridson scheme — geomlib/ccd.cpp, geometry.native.integrate_ccd_native).
    Fallback when geomlib is unavailable: a conservative vertex-path test —
    each vertex's segment old->new is cast against the OLD mesh (excluding
    its incident faces) and stopped at 90% of the first intersection
    (edge-edge sweeps are not modeled there).

    `rep` [V] (optional) maps vertices to merge representatives; contacts
    between primitives whose vertex sets meet under rep are skipped (edge
    collapses legitimately land the dropped vertex on the kept vertex's
    incident faces at t=1)."""
    old_v = np.asarray(old_v, np.float64)
    new_v = np.asarray(new_v, np.float64)
    if (not collision_aware or old_v.shape != new_v.shape
            or (f.size and f.max() >= old_v.shape[0])):
        # topology changed since old_v (remesh ran): nothing to integrate
        return new_v
    from . import native
    if native.available():
        return native.integrate_ccd_native(old_v, new_v, np.asarray(f),
                                           rep=rep)
    import torch

    from .intersect import moller_trumbore

    d = new_v - old_v
    dist = np.linalg.norm(d, axis=1)
    moving = dist > 1e-15
    if not moving.any():
        return new_v
    dirs = np.where(moving[:, None], d / np.maximum(dist, 1e-30)[:, None], 0.0)

    p1 = old_v[f[:, 0]]
    e1 = old_v[f[:, 1]] - p1
    e2 = old_v[f[:, 2]] - p1
    t, u, w, hit = moller_trumbore(
        *(torch.from_numpy(x) for x in (old_v, dirs, p1, e1, e2)))
    t = t.numpy()
    hit = hit.numpy()
    # exclude faces incident to the vertex (under rep when merging)
    V = old_v.shape[0]
    r = (np.arange(V) if rep is None
         else np.asarray(rep, np.int64))
    incident = np.zeros((V, f.shape[0]), bool)
    for k in range(3):
        incident[f[:, k], np.arange(f.shape[0])] = True
        if rep is not None:
            incident |= (r[:, None] == r[f[:, k]][None, :])
    ok = hit & ~incident & (t > 1e-9) & (t < dist[:, None])
    t_first = np.where(ok, t, np.inf).min(axis=1)
    scale = np.where(np.isfinite(t_first), 0.9 * t_first / np.maximum(dist, 1e-30),
                     1.0)
    scale = np.minimum(scale, 1.0)
    return old_v + d * scale[:, None]
