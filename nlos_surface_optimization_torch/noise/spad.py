"""Photon-level SPAD simulation for robustness experiments (PyTorch).

The JAX package's noise/spad.py, after the reference's spadModel.m /
spadModelScaled.m (Hernandez et al., "A Computational Model of a
Single-Photon Avalanche Diode Sensor for Transient Imaging").  For each
scan point, M laser pulses idx = 0..M-1:

    t   ~ a bin drawn from the ideal transient (1-based)
    t  += a jitter drawn from the measured histogram
    detected iff t in [1, B], u < pdp and, with pile-up, t + idx*RR > tLast
    on detection: count t; afterpulses at +HO with probability app^n
    tLast = t + HO(+...) + idx*RR
    background ~ Poisson(mu_noise * M / sum(counts) * B / len(jitters))

Each point draws from its own key (the run's key split over the points,
then into 5), with the JAX package's threefry: the bin and the jitter by
``sampling.choice`` (exact running sums), the detection and afterpulse
uniforms by ``sampling.uniform`` (bit for bit JAX's), the background by
``sampling.poisson``, and no float reduction runs across a point's row.
So on a device the result does not depend on the chunk of points it is
computed in.

Without pile-up (spadModelScaled, what the runner uses) a photon's
detection does not read tLast: the photons are independent and the
counts of a chunk of points are one scatter-add over (point, bin), with
no [M, B] intermediate.  With pile-up the carry is sequential: a loop
over the M photons, vectorized over the chunk's points.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import sampling


class SpadParams(NamedTuple):
    num_photons: int = 20_000        # M (addNoiseExample.m: 2e4)
    pdp: float = 1.0                 # photon detection probability
    app: float = 0.01                # afterpulsing probability
    dt: float = 4e-12                # temporal resolution (s)
    t_hold_off: float = 1e-6         # hold-off (s)
    laser_freq: float = 8e7          # pulse frequency (Hz)
    mu_noise: float = 10_000.0       # ambient level (addNoiseExample.m:6)
    max_afterpulses: int = 3         # APP^n truncation (1e-6 tail)
    pileup: bool = True              # False = spadModelScaled semantics


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _hold_off(params: SpadParams) -> int:
    """The hold-off HO in bins."""
    return int(round(params.t_hold_off / params.dt))


def _draws(keys, p, jit_bins, jit_counts, params: SpadParams, B: int):
    """The photons of a chunk of points [n]: (t0 [n, M] the drawn 1-based
    bin, t [n, M] the jittered one, ok [n, M] detected before the pile-up
    gate, the afterpulse uniforms [n, M, A] or None).  A draw that cannot
    change the counts is not made: the detection uniform when pdp >= 1
    (u < 1 always holds), the afterpulse ones when the hold-off passes the
    last bin."""
    M = params.num_photons
    k1, k2, k3, k4 = (keys[:, i] for i in range(4))
    t0 = sampling.choice(k1, B, (M,), p) + 1
    jit = jit_bins[sampling.choice(k2, jit_bins.shape[0], (M,), jit_counts)]
    t = t0 + jit
    ok = (t >= 1) & (t <= B) & (p.amax(dim=1, keepdim=True) > 0)
    if np.float32(params.pdp) < 1.0:
        ok &= sampling.uniform(k3, (M,)) < _f32(params.pdp, p.device)
    u_ap = None
    if _hold_off(params) < B and params.max_afterpulses > 0:
        u_ap = sampling.uniform(k4, (M, params.max_afterpulses))
    return t0, t, ok, u_ap


def _counts_independent(t, ok, u_ap, params: SpadParams, B: int):
    """Counts [n, B] of independent photons: one scatter-add over
    (point, bin) for the detections and one per afterpulse order."""
    n = t.shape[0]
    HO = _hold_off(params)
    row = torch.arange(n, device=t.device)[:, None] * B
    counts = torch.zeros(n * B, dtype=torch.float32, device=t.device)

    def add(mask, at):
        idx = (row + at - 1)[mask]
        counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))

    add(ok, t)
    if u_ap is not None:
        t_after, alive = t + HO, ok
        for m in range(1, params.max_afterpulses + 1):
            alive = alive & (t_after <= B) & (
                u_ap[..., m - 1] < _f32(params.app ** m, t.device))
            add(alive, t_after)
            t_after = torch.where(alive, t_after + HO, t_after)
    return counts.reshape(n, B)


def _counts_pileup(t0, t, ok, u_ap, params: SpadParams, B: int):
    """Counts [n, B] with the dead-time gate t0 + idx*RR > tLast: the
    photons in order, each step vectorized over the points."""
    n, M = t.shape
    HO = _hold_off(params)
    RR = int(round((1.0 / params.laser_freq) / params.dt))
    dev = t.device
    rows = torch.arange(n, device=dev)
    counts = torch.zeros(n, B, dtype=torch.float32, device=dev)
    t_last = torch.zeros(n, dtype=torch.int64, device=dev)
    thr = [_f32(params.app ** m, dev)
           for m in range(1, params.max_afterpulses + 1)]
    for idx in range(M):
        ti = t[:, idx]
        det = ok[:, idx] & (t0[:, idx] + idx * RR > t_last)
        counts[rows, (ti - 1).clamp(0, B - 1)] += det.float()
        t_after, alive = ti + HO, det
        if u_ap is not None:
            for m in range(1, params.max_afterpulses + 1):
                alive = alive & (t_after <= B) & (u_ap[:, idx, m - 1]
                                                  < thr[m - 1])
                counts[rows, (t_after - 1).clamp(0, B - 1)] += alive.float()
                t_after = torch.where(alive, t_after + HO, t_after)
        t_last = torch.where(det, t_after + idx * RR, t_last)
    return counts


def _spad_chunk(keys, transients, jit_bins, jit_counts, counts_total,
                params: SpadParams):
    """Noisy counts [n, B] of a chunk of points (keys [n, 2], ideal
    transients [n, B] float32)."""
    n, B = transients.shape
    sub = sampling.split(keys, 5)                                # [n, 5, 2]
    # the bins' weights as they are: choice needs no normalized p, and a
    # row with no light draws no photon (JAX's 0/0 would be NaN)
    p = torch.clamp(transients, min=0.0)
    t0, t, ok, u_ap = _draws(sub, p, jit_bins, jit_counts, params, B)
    if params.pileup:
        counts = _counts_pileup(t0, t, ok, u_ap, params, B)
    else:
        counts = _counts_independent(t, ok, u_ap, params, B)
    # background: muNoise * M / sum(jitterCounts) * tEnd / len(jittersAll)
    mu = (_f32(params.mu_noise * params.num_photons, transients.device)
          / counts_total * B / jit_bins.shape[0])
    return counts + sampling.poisson(sub[:, 4], mu, (B,))


def _calibration(jitters_s, jitter_counts, params: SpadParams, device):
    """(jitter bins int64, their counts f32, the counts' sum)."""
    js = torch.as_tensor(np.asarray(jitters_s), dtype=torch.float32,
                         device=device)
    jit_bins = torch.round(js / _f32(params.dt, device)).to(torch.int64)
    counts = torch.as_tensor(np.asarray(jitter_counts), dtype=torch.float32,
                             device=device)
    return jit_bins, counts, counts.sum()


def _as_key(key, device) -> torch.Tensor:
    return torch.as_tensor(key, dtype=torch.int64).to(device)


def spad_model(key, transient_ideal, jitters_s, jitter_counts,
               params: SpadParams = SpadParams(), device="cuda"
               ) -> torch.Tensor:
    """Noisy photon-count transient for ONE scan point [B] (float32).

    jitters_s: jitter sample values in SECONDS (jitter.mat t_1);
    jitter_counts: their histogram counts (counts_1)."""
    t = torch.as_tensor(transient_ideal, dtype=torch.float32, device=device)
    jit_bins, counts, total = _calibration(jitters_s, jitter_counts, params,
                                           device)
    return _spad_chunk(_as_key(key, t.device)[None], t[None], jit_bins,
                       counts, total, params)[0]


def spad_noisy_transients(key, transients, jitters_s, jitter_counts,
                          params: SpadParams = SpadParams(),
                          rescale: bool = True, source_chunk: int = 16,
                          device="cuda") -> torch.Tensor:
    """The SPAD model on every scan point [L, B] (float32, on ``device``);
    with rescale=True the counts are scaled back to the ideal energy / M
    (addNoiseExample.m:22-24: spadModelScaled(...) / M * sum(transient)).

    The key is split over the L points as the JAX package splits it, so
    the result is the same for any ``source_chunk``."""
    t = torch.as_tensor(transients, dtype=torch.float32, device=device)
    L = t.shape[0]
    keys = sampling.split(_as_key(key, t.device), L)
    jit_bins, counts, total = _calibration(jitters_s, jitter_counts, params,
                                           t.device)
    out = torch.cat([
        _spad_chunk(keys[s0:s0 + source_chunk], t[s0:s0 + source_chunk],
                    jit_bins, counts, total, params)
        for s0 in range(0, L, source_chunk)])
    if rescale:
        out = out / params.num_photons * t.sum(dim=1, keepdim=True)
    return out
