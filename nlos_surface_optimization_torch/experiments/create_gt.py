"""GT transient generation: render the GT mesh over the scan, sharded over
scan-point batches, each written to setup/<scene>_transient_<res>_<i>.mat
with the JAX package's keys (gt_transient, gt_v, gt_f, lighting,
bin_width)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.io
import torch.distributed as dist

from ..config import RenderConfig, make_confocal_scan
from ..geometry.accel import morton_order_faces
from ..geometry.mesh import make_mesh
from ..geometry.sampling import key as make_key
from ..parallel.shard import sharded_render_transient
from ..render.api import render_transient
from .scenes import SceneSpec


def create_gt(spec: SceneSpec, gt_v: np.ndarray, gt_f: np.ndarray,
              out_dir: str, num_shards: int = 64,
              resolution: Optional[int] = None,
              sample_num: Optional[int] = None,
              key=None, dmesh=None, device="cuda") -> list:
    """Render + shard GT transients on ``device``; returns the shard file
    list.  Shards already on disk are kept (each write is atomic).

    With ``dmesh`` (a ``parallel.shard.SourceMesh``) each shard renders
    source-sharded over its devices (its first device replaces
    ``device``).  Where it spans several ranks, the coordinator decides
    which shards are missing and tells every rank, so that all render the
    same shards (each render is collective), and only the coordinator
    writes."""
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
    if dmesh is not None:
        device = dmesh.device
    mesh = make_mesh(gt_v, gt_f, device=device)
    shards = np.array_split(np.arange(lighting.shape[0]), num_shards)
    files = [os.path.join(out_dir, f"{spec.name}_transient_{res}_{i}.mat")
             for i in range(num_shards)]
    writer = dmesh is None or dmesh.rank == 0
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    missing = [i for i, fn in enumerate(files) if not os.path.exists(fn)]
    if dmesh is not None and dmesh.group is not None:
        sent = [missing]
        dist.broadcast_object_list(sent, src=dist.get_global_rank(
            dmesh.group, 0), group=dmesh.group)
        missing = sent[0]

    for i in missing:
        idx = shards[i]
        if dmesh is None:
            t, _ = render_transient(mesh, lighting[idx], lnormal[idx], cfg,
                                    key, refine=1, alpha=alpha)
        else:
            t = sharded_render_transient(mesh, lighting[idx], lnormal[idx],
                                         cfg, key, dmesh, refine=1,
                                         alpha=alpha)
        if writer:
            scipy.io.savemat(files[i] + ".tmp", {
                "gt_transient": t.cpu().numpy(),
                "gt_v": gt_v, "gt_f": gt_f,
                "lighting": lighting[idx],
                "bin_width": spec.distance_resolution,
            })
            os.replace(files[i] + ".tmp", files[i])  # no partial shards
    if dmesh is not None and dmesh.group is not None:
        dist.barrier(group=dmesh.group)
    return files
