"""Aggregate per-iteration checkpoint dumps (numpy + scipy, a copy of the
JAX package's io/progress.py).

Walk a progress directory of %05d.mat dumps and stitch the scalar series
(l2, l2_original, face and vertex counts) plus the final geometry, as the
reference's MATLAB collect_progress_results.m does.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np
import scipy.io


def collect_progress(progress_dir: str) -> Dict[str, np.ndarray]:
    files = sorted(glob.glob(os.path.join(progress_dir, "[0-9]" * 5 + ".mat")))
    series: Dict[str, List] = {"iteration": [], "l2": [], "l2_original": [],
                               "num_vertices": [], "num_faces": []}
    last = None
    for fn in files:
        d = scipy.io.loadmat(fn, squeeze_me=True)
        series["iteration"].append(int(d.get("iteration", -1)))
        series["l2"].append(float(d.get("l2", np.nan)))
        series["l2_original"].append(float(d.get("l2_original", np.nan)))
        series["num_vertices"].append(int(np.atleast_2d(d["v"]).shape[0]))
        series["num_faces"].append(int(np.atleast_2d(d["f"]).shape[0]))
        last = d
    out = {k: np.asarray(v) for k, v in series.items()}
    if last is not None:
        out["final_v"] = np.atleast_2d(last["v"])
        out["final_f"] = np.atleast_2d(last["f"])
    return out
