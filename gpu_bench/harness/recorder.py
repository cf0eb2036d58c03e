"""What a driver records of the iterations it runs: their seconds and
paths, host spans and, in a traced segment, the shapes of every render
(the roofline readers count from them)."""

from __future__ import annotations

import torch


class Recorder:
    """Iterations of a window, host spans and, in a traced segment, the
    shapes of every render.  ``sync``: synchronize every card of the cell
    at span ends, so that spans time the cards' work (the traced run's
    window only)."""

    def __init__(self, sync: bool = False, shapes: bool = False):
        self.sync, self.shapes = sync, shapes
        self.iterations, self.spans, self.renders = [], [], []

    def span(self, name, t0, t1):
        self.spans.append((name, t0, t1))


def cards(devices):
    """The distinct CUDA devices among ``devices``, in order (a card that
    holds several virtual shards once)."""
    return [d for d in dict.fromkeys(torch.device(x) for x in devices)
            if d.type == "cuda"]


def sync(devices):
    """Wait for every card among ``devices``."""
    for d in cards(devices):
        torch.cuda.synchronize(d)


def shading(cfg) -> dict:
    """The shading a render config asks for, as the reference reads it."""
    return dict(normal=cfg.normal,
                gn=cfg.normal == "vn" and cfg.testing_flag == 0,
                brdf=cfg.brdf)


def render_shape(kind, mesh, cfg, L, Fv):
    """The sizes a render's kernels see: chunks of Lc sources over the
    mesh's F (padded) faces, spt samples a face from its Fv valid ones."""
    sh = shading(cfg)
    return dict(kind=kind, L=int(L), Lc=int(min(cfg.source_chunk or L, L)),
                F=int(mesh.f.shape[0]), Fv=int(Fv), V=int(mesh.v.shape[0]),
                spt=int(cfg.samples_per_face(Fv)),
                B=int(cfg.num_bins), refine_fwd=int(cfg.forward_refine),
                refine=int(cfg.bin_refine_resolution),
                sigma_bin=int(cfg.sigma_bin), vn=sh["normal"] == "vn",
                gn=sh["gn"], fused_bwd=cfg.brdf == "lambertian",
                sms=(torch.cuda.get_device_properties(mesh.v.device)
                     .multi_processor_count
                     if mesh.v.device.type == "cuda" else 132))
