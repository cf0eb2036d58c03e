""".mat interop and checkpointing (numpy + scipy), copied from the JAX package.

GT transient shards, measured captures, the measured jitter kernel, and
the one-file resume checkpoint of the outer loop.  The checkpoint keys
are the JAX package's (``v``, ``f``, ``iteration``, ``rng_key``,
``opt_*``, ``ls_*`` loop-state scalars, ``hist_*`` histories), so a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import scipy.io


def load_transient_shards(filenames: Iterable[str], key: str = "gt_transient"
                          ) -> np.ndarray:
    """Concatenate GT transient shards row-wise (exp_bunny/test.py:69-75)."""
    parts = [scipy.io.loadmat(fn)[key] for fn in filenames]
    return np.concatenate(parts, axis=0)


def load_real_capture(path: str, zero_bins: int = 600,
                      downsample: int = 1):
    """Measured SPAD capture -> (transient [L,B] f64, lighting [L,3] or
    None, scan N).

    Layout contract of the reference's real scenes (exp_s/transient.mat,
    exp_su/compute_init_su.m:36-44): key 'transient' is [N*N, B] (or
    'rect_data' is [N, N, B]), optional 'lighting' [N*N, 3]; the first
    `zero_bins` bins carry direct-bounce contamination and are zeroed
    (exp_s/test.py:66-67 zeroes bins 0..599).

    `downsample=k` keeps every k-th scan point along both scan axes (a
    practical knob for reduced-scale runs; 1 = the reference's full 64x64).
    """
    m = scipy.io.loadmat(path)
    # np.array (not asarray): forces a copy so the in-place bin zeroing
    # below can never alias loadmat's buffer; row-major, as the kernels'
    # wrappers take their inputs (loadmat's arrays are column-major)
    if "transient" in m:
        t = np.array(m["transient"], dtype=np.float64, order="C")
        L = t.shape[0]
        n = int(round(L ** 0.5))
        assert n * n == L, f"scan must be square, got L={L}"
    else:
        rect = np.array(m["rect_data"], dtype=np.float64, order="C")
        n = rect.shape[0]
        t = rect.reshape(n * n, rect.shape[-1])
    t[:, :zero_bins] = 0.0
    lighting = None
    if "lighting" in m:
        lighting = np.ascontiguousarray(m["lighting"], dtype=np.float32)
    if downsample > 1:
        k = downsample
        idx = (np.arange(0, n, k)[:, None] * n
               + np.arange(0, n, k)[None, :]).reshape(-1)
        t = t[idx]
        if lighting is not None:
            lighting = lighting[idx]
        n = len(range(0, n, k))
    return t, lighting, n


def load_jitter_calibration(path: str):
    """Measured SPAD temporal-jitter kernel -> (weight [K] f64, grad [K]
    f64, offset int), from the keys 'jitter_weight' [K,1], 'jitter_grad'
    [K,1] and 'jitter_offset' (scalar) of jitter/jitter_info.mat."""
    m = scipy.io.loadmat(path)
    weight = np.asarray(m["jitter_weight"], dtype=np.float64).ravel()
    grad = np.asarray(m["jitter_grad"], dtype=np.float64).ravel()
    offset = int(np.asarray(m["jitter_offset"]).ravel()[0])
    return weight, grad, offset


def save_checkpoint(path: str, *, v: np.ndarray, f: np.ndarray,
                    iteration: int, rng_key: np.ndarray,
                    opt_m: Optional[np.ndarray] = None,
                    opt_v: Optional[np.ndarray] = None,
                    opt_step: int = 0,
                    loop_state: Optional[dict] = None,
                    history: Optional[dict] = None,
                    extra: Optional[dict] = None) -> None:
    """One-file resume checkpoint (scipy .mat so MATLAB tooling can read the
    same dumps the reference's collect_progress_results.m consumes).

    `loop_state` / `history` carry the outer loop's full phase-machine
    snapshot AT THE START of the checkpointed iteration (scalars prefixed
    `ls_`, history rows prefixed `hist_`) so
    InverseRenderingLoop.from_checkpoint can re-execute that iteration
    bit-for-bit — the beyond-parity feature the reference lacks (its
    progress dumps hold only mesh+transient, exp_bunny/test.py:186-187)."""
    payload = {
        "v": np.asarray(v), "f": np.asarray(f),
        "iteration": iteration, "rng_key": np.asarray(rng_key),
        "opt_step": opt_step,
    }
    if opt_m is not None:
        payload["opt_m"] = np.asarray(opt_m)
    if opt_v is not None:
        payload["opt_v"] = np.asarray(opt_v)
    if loop_state:
        for k, val in loop_state.items():
            payload["ls_" + k] = np.asarray(val)
    if history:
        for k, val in history.items():
            payload["hist_" + k] = np.asarray(val, np.float64)
    if extra:
        payload.update({k: np.asarray(val) for k, val in extra.items()})
    tmp = path + ".tmp"
    scipy.io.savemat(tmp, payload, do_compression=True)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    d = scipy.io.loadmat(path, squeeze_me=True)
    return {k: v for k, v in d.items() if not k.startswith("__")}
