"""Sharding of forward and inverse rendering over the source axis.

The L scan points are split into ``mesh.size`` contiguous shards of
Ls = ceil(L/n) sources (padded sources have a zero lighting normal and a
zero weight, so they contribute exactly zero); every shard holds the
whole triangle mesh on its device and renders its sources through the
single-device chunk loop (``render.api.transient_rows`` /
``inverse_rows``: kernel K1 forward and K2 backward on the card), with
the sources' GLOBAL indices as sampling offsets.  So the transient is
bit-identical for any shard count; the gradient differs only in the
order of its f32 sums.

A ``SourceMesh`` spans the ranks of a process group, each with one or
more local shards (a device may repeat: ``["cpu"] * 8`` is eight virtual
shards in one process).  Global shard index = rank * local + j.  The
vertex gradient, or the albedo or alpha scalar, is added over the local
shards in shard order on the first local device, all-reduced (SUM) over
the group, then divided by L.  The transient's rows are gathered on every
rank in rank order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import RenderConfig, check_backends
from ..geometry.mesh import Mesh
from ..render.api import (
    _padded_rows,
    _prepare,
    _spt,
    inverse_rows,
    transient_rows,
    vertex_csr_for,
)
from ..render.core import _lambertian_only

AXIS = "sources"
SHARDED_MODES = ("vertex", "albedo", "alpha")


class SourceMesh(NamedTuple):
    """The shards of the source axis: this process's ``devices`` (one per
    local shard), the process ``group`` (None: this process alone), its
    ``rank`` and the group's ``world`` size."""

    devices: Tuple[torch.device, ...]
    group: Optional[dist.ProcessGroup]
    rank: int
    world: int

    @property
    def size(self) -> int:
        return self.world * len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_source_mesh(devices: Optional[Sequence] = None,
                     group: Optional[dist.ProcessGroup] = None) -> SourceMesh:
    """A source mesh over ``devices`` (default: every visible CUDA device)
    in ``group`` (default: the default process group where one is
    initialized, else this process alone)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_source_mesh: no CUDA device; pass the "
                               "devices (e.g. ['cpu'] * n) explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_source_mesh: no devices")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return SourceMesh(devices, None, 0, 1)
    return SourceMesh(devices, group, dist.get_rank(group),
                      dist.get_world_size(group))


def _local_shards(dmesh: SourceMesh, L: int):
    """(Ls, Lp, [(global shard index, device)]) of this rank."""
    Ls = math.ceil(L / dmesh.size)
    local = len(dmesh.devices)
    return Ls, Ls * dmesh.size, [(dmesh.rank * local + j, d)
                                 for j, d in enumerate(dmesh.devices)]


def _per_device(mesh: Mesh, devices, cfg: RenderConfig, key, mode=None):
    """{device: (mesh, key, (face hierarchy, face normals and areas),
    vertex CSR)}, each built once a call for every shard on that device."""
    out = {}
    for d in devices:
        if d not in out:
            m = Mesh(*(x.to(d) for x in mesh))
            out[d] = (m, key.to(d), _prepare(m, cfg),
                      None if mode is None else vertex_csr_for(m, cfg, mode))
    return out


def _gather_rows(parts, dmesh: SourceMesh, L: int) -> torch.Tensor:
    """The local shards' rows on the first local device, then every
    rank's (equal-sized) block in rank order: [L, B] on every rank."""
    rows = torch.cat([p.to(dmesh.device) for p in parts], dim=0)
    if dmesh.group is not None:
        blocks = [torch.empty_like(rows) for _ in range(dmesh.world)]
        dist.all_gather(blocks, rows, group=dmesh.group)
        rows = torch.cat(blocks, dim=0)
    return rows[:L]


def _reduce(parts, dmesh: SourceMesh) -> torch.Tensor:
    """The local partial gradients added in shard order on the first local
    device, then summed over the group."""
    g = parts[0].to(dmesh.device)
    for p in parts[1:]:
        g = g + p.to(dmesh.device)
    if dmesh.group is not None:
        flat = g.reshape(-1)   # a scalar as one element
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=dmesh.group)
        g = flat.reshape(g.shape)
    return g


def sharded_render_transient(mesh: Mesh, lighting, lighting_normal,
                             cfg: RenderConfig, key, dmesh: SourceMesh,
                             refine: Optional[int] = None, alpha=None):
    """Forward transient [L, B] with the sources sharded over ``dmesh``,
    on every rank (on the mesh's first device)."""
    check_backends(cfg)
    spt = _spt(cfg, mesh)
    r = cfg.bin_refine_resolution if refine is None else refine
    L = len(lighting)
    Ls, Lp, shards = _local_shards(dmesh, L)
    lit, nrm = (_padded_rows(x, Lp, dmesh.device)
                for x in (lighting, lighting_normal))
    state = _per_device(mesh, dmesh.devices, cfg, key)
    parts = []
    for s, d in shards:
        m, k, (hier, faces), _ = state[d]
        rows = slice(s * Ls, (s + 1) * Ls)
        parts.append(transient_rows(m, lit[rows].to(d), nrm[rows].to(d), k,
                                    cfg, spt, r, hier, alpha,
                                    source_offset=s * Ls, faces=faces))
    return _gather_rows(parts, dmesh, L)


def sharded_inverse_render(mesh: Mesh, data, weight, lighting,
                           lighting_normal, cfg: RenderConfig, key,
                           dmesh: SourceMesh, alpha=None,
                           mode: str = "vertex"):
    """(transient [L, B], gradient) with the sources sharded over
    ``dmesh``, both on every rank.

    mode: 'vertex' -> [V, 3] vertex gradient; 'albedo' / 'alpha' -> the
    scalar.  As the JAX package's sharded body does, the difference is
    weight * f(data - T) without cfg.loss_smooth_width's box smoothing
    (the single-device inverse_render applies it)."""
    if mode not in SHARDED_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {SHARDED_MODES}")
    if mode == "alpha" and alpha is None:
        raise ValueError("mode='alpha' needs the roughness alpha")
    if mode == "albedo":
        _lambertian_only(cfg, "the albedo gradient")
    check_backends(cfg)
    cfg = cfg.replace(loss_smooth_width=0)
    spt = _spt(cfg, mesh)
    L = len(lighting)
    Ls, Lp, shards = _local_shards(dmesh, L)
    lit, nrm, dat, w = (_padded_rows(x, Lp, dmesh.device)
                        for x in (lighting, lighting_normal, data, weight))
    state = _per_device(mesh, dmesh.devices, cfg, key, mode)
    ts, gs = [], []
    for s, d in shards:
        m, k, (hier, faces), csr = state[d]
        rows = slice(s * Ls, (s + 1) * Ls)
        # each shard starts its own sum: the fused backward adds in place
        t, g = inverse_rows(m, dat[rows].to(d), w[rows].to(d),
                            lit[rows].to(d), nrm[rows].to(d), k, cfg, spt,
                            mode, alpha, hier, csr, source_offset=s * Ls,
                            faces=faces)
        ts.append(t)
        gs.append(g)
    return _gather_rows(ts, dmesh, L), _reduce(gs, dmesh) / float(L)
