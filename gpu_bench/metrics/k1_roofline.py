"""Kernel K1 (csrc/occluded_splat.cu: occlusion, then the splat's
reduction) against its bytes bound, in %.  Bounded by bytes only: its
operations depend on the broad phase's data, which no span exposes.
A chunk of Lc sources over F faces (padding included), R = Lc*F*spt
rays, reads o, d [R, 3] f32, t, contrib [R] f32, fid, bins [R] int32,
v [V, 3] f32, f [F, 3] int64, f_valid [F] bool, and writes the
occlusion mask [R] bool and the histogram [Lc, B*refine] f32."""

from gpu_bench.harness import roofline

KERNELS = ("occl_kernel", "splat_reduce_kernel", "splat_sum_kernel")


def chunk(r):
    R = r["Lc"] * r["F"] * r["spt"]
    nbytes = (40 * R + 12 * r["V"] + 25 * r["F"] + R
              + 4 * r["Lc"] * r["B"] * r["refine_fwd"])
    return roofline.bound_seconds(0.0, nbytes)


def read(ctx):
    return roofline.share(ctx, KERNELS, "inverse", chunk)
