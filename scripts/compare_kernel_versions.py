#!/usr/bin/env python3
"""Time kernels K1, K2 and K3 of one version of the PyTorch port on a CUDA
card.

    python3 scripts/compare_kernel_versions.py DIR [--profile OUT]

DIR holds a version of the repo: this checkout (``.``) or an earlier one
unpacked with ``git archive``.  The script imports the
``nlos_surface_optimization_torch`` package under DIR, builds its kernels
and times K1 and K3 at the kernel cases of this checkout's
``chip_smoke.py`` (the flagship chunk, ``large``, ``gt``, the loop's K3
chunk, ``big_mesh``), one JSON line per case: the wrapper as a render
calls it (``ms``), its kernel launches alone (``kernel_ms``) and its
preparation (``prep_ms``).  K2 at its cases (the flagship chunk in 'fn'
and 'vn', ``large`` in 'vn'): the face-sum wrapper on prebuilt arguments,
its device time (``ms``, ``chip_smoke.device_ms``) and its calls' rate
with the host's time (``wrapper_ms``), then, host time included, the
epilogue from the face sums to the running gradient (``epilogue_ms``)
and the whole per-chunk backward from a RayBatch and a difference to the
running gradient (``chunk_ms``).  With --profile, one
descent step at the ``large`` shapes runs under torch.profiler
(``chip_smoke.profile_large``; its table goes to OUT).  To compare two
versions in one call on one card, run it once per DIR, alternating (a,
b, b, a).  ``inputs_sum`` shows that both versions were given the same
inputs.  Results are not checked here: ``chip_smoke.py`` holds each
kernel to its plain version.

Two layouts of K2 are understood: the one with the tap reduction in the
kernel and the epilogue kernel (``bwd_kernels.vertex_epilogue``), and the
one before it (tap tables built per chunk, slabs summed and the vertex
gradient computed by torch ops, the running gradient added by the
caller; its ``ms`` includes the slab sum).

Two package layouts of K1 and K3 are understood: the one with the face hierarchy
(``fused_kernels.face_hierarchy``, built once per render, the broad phase
inside the kernels), and the one before it, whose broad phase ran as
torch ops per chunk (``fused_kernels.broad_phase(..., ka_max=)`` and the
face soup for K1; ``occl_kernels.ray_groups`` and one broad phase and
launch per ray group for K3).
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stages(fk, ok):
    """(k1, k3): for one case's (args, kwargs), the callables to time in
    the package version at hand -> {ms, kernel_ms, prep_ms}."""
    if hasattr(fk, "face_hierarchy"):
        def k1(args, kw):
            hier = fk.face_hierarchy(*args[6:9])
            return dict(
                ms=lambda: fk.occluded_splat(*args, **kw, hier=hier),
                kernel_ms=lambda: fk.kernel_call(*args[:6], hier, *args[9:],
                                                 **kw),
                prep_ms=lambda: fk.face_hierarchy(*args[6:9]))

        def k3(args, kw):
            hier = fk.face_hierarchy(*args[4:7])
            return dict(
                ms=lambda: ok.segment_occluded(*args, **kw, hier=hier),
                kernel_ms=lambda: ok.kernel_call(*args[:4], hier, **kw),
                prep_ms=lambda: fk.face_hierarchy(*args[4:7]))
        return k1, k3

    def k1_torch_broad_phase(args, kw):
        o, d, t, fid, c, b, v, f, fv, Lc, Bf = args

        def prep():
            return (fk.broad_phase(o, d, t, Lc, v, f, fv, ka_max=fk.KA_MAX),
                    fk.face_soup(v, f, fv, -(-f.shape[0] // fk.GF)))
        (counts, lists, nbs), soup = prep()
        return dict(
            ms=lambda: fk.occluded_splat(*args, **kw),
            kernel_ms=lambda: fk.kernel_call(o, d, t, fid, c, b, soup, counts,
                                             lists, nbs, Lc, Bf, **kw),
            prep_ms=prep)

    def k3_torch_broad_phase(args, kw):
        o, d, t, fid, v, f, fv = args

        def prep():
            ng = -(-f.shape[0] // fk.GF)
            boxes = fk._group_boxes(v, f, fv, ng, fk.GF)
            return fk.face_soup(v, f, fv, ng), [
                (r0, r1) + ok.broad_phase(o[r0:r1], d[r0:r1], t[r0:r1], boxes)
                for r0, r1 in ok.ray_groups(o.shape[0], ng)]
        soup, plan = prep()
        out = torch.empty(o.shape[0], dtype=torch.uint8, device=o.device)

        def kernels():
            for r0, r1, counts, lists in plan:
                ok.kernel_call(o[r0:r1], d[r0:r1], t[r0:r1], fid[r0:r1], soup,
                               counts, lists, kw["t_rel"], kw["t_min"],
                               out[r0:r1])
        return dict(ms=lambda: ok.segment_occluded(*args, **kw),
                    kernel_ms=kernels, prep_ms=prep)
    return k1_torch_broad_phase, k3_torch_broad_phase


def k2_stages(bk, case):
    """For one K2 case (rays, mesh, lnormal, diff, cfg, spt), the callables
    to time in the package version at hand -> {ms, epilogue_ms,
    chunk_ms}."""
    rays, mesh, nc, diff, cfg, spt = case
    grad = torch.zeros_like(mesh.v)
    args = bk.face_sum_inputs(rays, nc, diff, 0, cfg, spt)
    if hasattr(bk, "vertex_epilogue"):
        partial = bk.backward_face_sums(*args)
        csr = bk.vertex_csr(mesh.f, mesh.f_valid, mesh.v.shape[0])
        return dict(
            ms=lambda: bk.backward_face_sums(*args),
            epilogue_ms=lambda: bk.vertex_epilogue(partial, mesh, csr, grad),
            chunk_ms=lambda: bk.backward_chunk_fused(
                rays, mesh, nc, diff, 0, cfg, spt, csr=csr, grad=grad))
    sums = bk.backward_face_sums(*args)
    return dict(
        ms=lambda: bk.backward_face_sums(*args),
        epilogue_ms=lambda: grad + bk.vertex_gradient(sums, mesh),
        chunk_ms=lambda: grad + bk.backward_chunk_fused(
            rays, mesh, nc, diff, 0, cfg, spt))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    profile = None
    if len(argv) == 3 and argv[1] == "--profile":
        profile, argv = argv[2], argv[:1]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernel_versions: no CUDA device", file=sys.stderr)
        return 2
    # the cases come from this checkout's chip_smoke.py, the package from
    # DIR: import chip_smoke first, then put DIR ahead on the path
    sys.path.append(REPO)
    import chip_smoke as cs

    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    import nlos_surface_optimization_torch as pt
    from nlos_surface_optimization_torch import _cuda
    from nlos_surface_optimization_torch.geometry.accel import (
        morton_order_faces,
    )
    from nlos_surface_optimization_torch.render import bwd_kernels as bk
    from nlos_surface_optimization_torch.render import fused_kernels as fk
    from nlos_surface_optimization_torch.render import occl_kernels as ok

    cs.require(os.path.dirname(os.path.abspath(pt.__file__)) == os.path.join(
        root, "nlos_surface_optimization_torch"),
        f"imported {pt.__file__}, not the package under {root}")
    cs.CARD = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cs.emit("versions", root=argv[0], build_seconds=_cuda.build_all())
    k1, k3 = stages(fk, ok)
    v, f, _ = cs.flagship_scene()
    lv, lf = cs.large_scene()
    bv, bf, _ = cs.height_field(200, 0.35, 0.6, 0.01, 1)
    bf = morton_order_faces(bv, bf)
    big = pt.make_mesh(bv, bf, device=dev)
    cases = [
        ("k1", "flagship", k1, lambda: cs.chunk_inputs(dev, v, f, True)),
        ("k1", "large", k1, lambda: cs.chunk_inputs(dev, lv, lf, True)),
        ("k1", "gt", k1, lambda: cs.gt_case_inputs(dev)),
        ("k3", "loop_chunk", k3, lambda: cs.chunk_inputs(dev, v, f, False)),
        ("k3", "large", k3, lambda: cs.chunk_inputs(dev, lv, lf, False)),
        ("k3", "big_mesh", k3, lambda: (tuple(
            torch.from_numpy(x).to(dev)
            for x in cs.surface_rays(bv, bf, 4096, 2)) + tuple(big[:3]),
            dict(t_rel=1e-4, t_min=1e-6)))]
    for kernel, name, make_stages, make_inputs in cases:
        args, kw = make_inputs()
        digest = float(sum(float(x.double().sum()) for x in args
                           if torch.is_tensor(x) and x.is_floating_point()))
        fns = make_stages(args, kw)
        cs.emit("versions", root=argv[0], kernel=kernel, case=name,
                inputs_sum=digest,
                **{k: cs.timed_ms(fn, 5) for k, fn in fns.items()})
    for name, make in (
            ("flagship", lambda: cs.k2_case_inputs(
                dev, v, f, "fn", cs.FLAGSHIP["source_chunk"])),
            ("flagship_vn", lambda: cs.k2_case_inputs(
                dev, v, f, "vn", cs.FLAGSHIP["source_chunk"])),
            ("large", lambda: cs.k2_case_inputs(dev, lv, lf, "vn"))):
        case = make()
        digest = float(sum(float(x.double().sum()) for x in case[0]
                           if x.is_floating_point()) + case[3].sum())
        fns = k2_stages(bk, case)
        cs.emit("versions", root=argv[0], kernel="k2", case=name,
                inputs_sum=digest, ms=cs.device_ms(fns["ms"], 20),
                wrapper_ms=cs.timed_ms(fns["ms"], 20),
                epilogue_ms=cs.timed_ms(fns["epilogue_ms"], 20),
                chunk_ms=cs.timed_ms(fns["chunk_ms"], 20))
    if profile:
        cs.profile_large(dev, profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
