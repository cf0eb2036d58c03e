"""Kernel K3 (csrc/segment_occluded.cu) in the culling render against its
bytes bound, in %.  Bounded by bytes only, as K1.  A chunk of Lc sources,
R = Lc*F*spt rays, reads o, d [R, 3] f32, t [R] f32, fid [R] int32,
v [V, 3] f32, f [F, 3] int64, f_valid [F] bool and writes the mask
[R] bool."""

from gpu_bench.harness import roofline

KERNELS = ("segment_occluded_kernel",)


def chunk(r):
    R = r["Lc"] * r["F"] * r["spt"]
    return roofline.bound_seconds(0.0, 33 * R + 12 * r["V"] + 25 * r["F"])


def read(ctx):
    return roofline.share(ctx, KERNELS, "intensity", chunk)
