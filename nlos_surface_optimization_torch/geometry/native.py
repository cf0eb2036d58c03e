"""ctypes bindings to geomlib (C++ mesh surgery), copied from the JAX package.

Loads the shared geomlib/libgeomlib.so at the repository root (running
``make`` there first, a no-op when the library is current); the callers in
geometry/remesh.py fall back to the pure-Python implementations when it is
unavailable.  ``available()`` says whether it loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _geomlib_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "geomlib")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    d = _geomlib_dir()
    so = os.path.join(d, "libgeomlib.so")
    # make is a no-op when the .so is newer than the sources; it also
    # rebuilds stale binaries (e.g. a checkout carrying an old .so).
    try:
        subprocess.run(["make", "-C", d], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        pass
    if not os.path.exists(so):
        return None
    lib = ctypes.CDLL(so)
    lib.geomlib_isotropic_remesh.restype = ctypes.c_int
    lib.geomlib_isotropic_remesh.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.geomlib_topo_remesh.restype = ctypes.c_int
    lib.geomlib_topo_remesh.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.geomlib_face_affinity.restype = None
    lib.geomlib_face_affinity.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.geomlib_integrate_ccd.restype = ctypes.c_int
    lib.geomlib_integrate_ccd.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
    ]
    lib.geomlib_integrate_ccd_rep.restype = ctypes.c_int
    lib.geomlib_integrate_ccd_rep.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def isotropic_remesh_native(v: np.ndarray, f: np.ndarray,
                            target_edge_length: float, iterations: int = 3,
                            protect_border: bool = True,
                            grow: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """C++ isotropic remesh; raises RuntimeError if geomlib unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("geomlib not built")
    v = np.ascontiguousarray(v, np.float64)
    f = np.ascontiguousarray(f, np.int32)
    cap_v = max(grow * v.shape[0], 1024)
    cap_f = max(grow * f.shape[0], 2048)
    for _ in range(4):
        out_v = np.empty((cap_v, 3), np.float64)
        out_f = np.empty((cap_f, 3), np.int32)
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        rc = lib.geomlib_isotropic_remesh(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), v.shape[0],
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
            float(target_edge_length), int(iterations),
            1 if protect_border else 0,
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap_v,
            out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap_f,
            ctypes.byref(nv), ctypes.byref(nf),
        )
        if rc == 0:
            return (out_v[: nv.value].astype(np.float32),
                    out_f[: nf.value].copy())
        cap_v = max(cap_v, nv.value)
        cap_f = max(cap_f, nf.value)
    raise RuntimeError("geomlib buffers kept overflowing")


def topo_remesh_native(v: np.ndarray, f: np.ndarray,
                       target_edge_length: float, iterations: int = 3,
                       merge_eps: float = None,
                       max_volume_change: float = 0.01,
                       protect_border: bool = True,
                       grow: int = 8):
    """El Topo static-operations parity: remesh WITH topology changes
    (zipper merge of sheets within merge_eps, default edge_length/10 like
    c_el_topo_api.cpp:40) and the per-operation volume cap (:30).

    Returns (v, f, num_merges)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("geomlib not built")
    if merge_eps is None:
        merge_eps = target_edge_length / 10.0
    v = np.ascontiguousarray(v, np.float64)
    f = np.ascontiguousarray(f, np.int32)
    cap_v = max(grow * v.shape[0], 1024)
    cap_f = max(grow * f.shape[0], 2048)
    for _ in range(4):
        out_v = np.empty((cap_v, 3), np.float64)
        out_f = np.empty((cap_f, 3), np.int32)
        nv = ctypes.c_int64()
        nf = ctypes.c_int64()
        nm = ctypes.c_int64()
        rc = lib.geomlib_topo_remesh(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), v.shape[0],
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
            float(target_edge_length), int(iterations), float(merge_eps),
            float(max_volume_change), 1 if protect_border else 0,
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap_v,
            out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap_f,
            ctypes.byref(nv), ctypes.byref(nf), ctypes.byref(nm),
        )
        if rc == 0:
            return (out_v[: nv.value].astype(np.float32),
                    out_f[: nf.value].copy(), int(nm.value))
        cap_v = max(cap_v, nv.value)
        cap_f = max(cap_f, nf.value)
    raise RuntimeError("geomlib buffers kept overflowing")


def face_affinity_native(f: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("geomlib not built")
    f = np.ascontiguousarray(f, np.int32)
    out = np.empty((f.shape[0], 3), np.int32)
    lib.geomlib_face_affinity(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def integrate_ccd_native(old_v: np.ndarray, new_v: np.ndarray,
                         f: np.ndarray, max_passes: int = 8,
                         rep: Optional[np.ndarray] = None) -> np.ndarray:
    """Collision-safe vertex integration with full CCD (vertex-triangle +
    edge-edge first-contact times, geomlib/ccd.cpp) — the el_topo_integrate
    role (c_el_topo_api.cpp:75-101).  Raises RuntimeError if geomlib is
    unavailable.

    `rep` [V] i32 (optional) maps vertices to merge representatives:
    primitive pairs whose vertex sets meet under rep are treated as
    adjacent (contacts between them skipped) — required for edge-collapse
    validation, where the dropped vertex legitimately lands on the kept
    vertex's incident faces at t=1."""
    lib = _load()
    if lib is None:
        raise RuntimeError("geomlib not built")
    old_v = np.ascontiguousarray(old_v, np.float64)
    new_v = np.ascontiguousarray(new_v, np.float64)
    f = np.ascontiguousarray(f, np.int32)
    out = np.empty_like(old_v)
    if rep is None:
        rep_ptr = ctypes.POINTER(ctypes.c_int32)()
    else:
        rep = np.ascontiguousarray(rep, np.int32)
        assert rep.shape == (old_v.shape[0],)
        rep_ptr = rep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.geomlib_integrate_ccd_rep(
        old_v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        new_v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        old_v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), f.shape[0],
        rep_ptr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(max_passes),
    )
    return out
