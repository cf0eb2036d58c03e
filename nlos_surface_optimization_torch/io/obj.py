"""Minimal OBJ mesh I/O (a copy of the JAX package's io/obj.py).

The reference uses libigl's readOBJ/writeOBJ for all mesh interchange
(exp_bunny/test.py:84-87, compute_init_mesh.m writes OBJ).  Only v/f (+vn)
records are needed by the pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(v [V,3] f32, f [F,3] i32).  Triangulates polygon faces by fanning;
    ignores texture/normal indices (v//vt//vn)."""
    verts = []
    faces = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def write_obj(path: str, v: np.ndarray, f: np.ndarray,
              vn: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as fh:
        for p in np.asarray(v):
            fh.write(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        if vn is not None:
            for n in np.asarray(vn):
                fh.write(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}\n")
        for tri in np.asarray(f):
            fh.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")
