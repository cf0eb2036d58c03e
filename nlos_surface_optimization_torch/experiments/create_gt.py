"""GT transient generation: render the GT mesh over the scan, sharded over
scan-point batches, each written to setup/<scene>_transient_<res>_<i>.mat
with the JAX package's keys (gt_transient, gt_v, gt_f, lighting,
bin_width)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.io

from ..config import RenderConfig, make_confocal_scan
from ..geometry.accel import morton_order_faces
from ..geometry.mesh import make_mesh
from ..geometry.sampling import key as make_key
from ..render.api import render_transient
from .scenes import SceneSpec


def create_gt(spec: SceneSpec, gt_v: np.ndarray, gt_f: np.ndarray,
              out_dir: str, num_shards: int = 64,
              resolution: Optional[int] = None,
              sample_num: Optional[int] = None,
              key=None, dmesh=None, device="cuda") -> list:
    """Render + shard GT transients on ``device``; returns the shard file
    list.  Shards already on disk are kept (each write is atomic)."""
    if dmesh is not None:
        raise NotImplementedError(
            "source-sharded GT rendering is not ported yet "
            "(ROADMAP queue 1, item 12)")
    res = resolution or spec.gt_scan_resolution
    samples = sample_num or spec.gt_sample_num
    key = make_key(0) if key is None else key

    # cap the per-chunk ray count (Lc*F*spt) near 2M, as the loop does
    F = int(gt_f.shape[0])
    spt0 = 1 + (samples - 1) // max(F, 1)
    chunk = max(1, min(256, 2_000_000 // max(F * spt0, 1)))
    cfg = RenderConfig(num_samples=samples, num_bins=spec.num_bins,
                       distance_resolution=spec.distance_resolution,
                       source_chunk=chunk, brdf=spec.brdf)
    # a GGX scene's GT renders at the scene's own roughness
    alpha = spec.ggx_alpha if spec.brdf == "ggx" else None
    lighting, lnormal = make_confocal_scan(res, lower=spec.scan_lower,
                                           upper=spec.scan_upper)
    # Morton order keeps the occlusion kernel's candidate lists short; it
    # only permutes the sampling RNG and the f32 summation order
    gt_f = morton_order_faces(gt_v, gt_f)
    mesh = make_mesh(gt_v, gt_f, device=device)
    shards = np.array_split(np.arange(lighting.shape[0]), num_shards)

    os.makedirs(out_dir, exist_ok=True)
    files = []
    for i, idx in enumerate(shards):
        fn = os.path.join(out_dir, f"{spec.name}_transient_{res}_{i}.mat")
        if not os.path.exists(fn):
            t, _ = render_transient(mesh, lighting[idx], lnormal[idx], cfg,
                                    key, refine=1, alpha=alpha)
            scipy.io.savemat(fn + ".tmp", {
                "gt_transient": t.cpu().numpy(),
                "gt_v": gt_v, "gt_f": gt_f,
                "lighting": lighting[idx],
                "bin_width": spec.distance_resolution,
            })
            os.replace(fn + ".tmp", fn)  # crash-safe: no partial shards
        files.append(fn)
    return files
