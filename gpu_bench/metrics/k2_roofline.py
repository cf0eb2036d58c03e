"""Kernel K2 and its epilogue (csrc/backward_face_sums.cu) against their
bound, in %.  face_sums_kernel reads dirs, bary [R, 3], h, albedo [R]
f32, valid [R] bool, the shading normals ([R, 3] in 'vn', face normals
[F, 3] in 'fn'), area [F], the source normals [Lc, 3], the chunk's
difference rows [Lc, B] and the tap weights [2, refine, G], and writes
[nslab, F, 12] f32; it does 94 fp32 operations a ray, 23 more with the
gn term and 4*G for the taps (G = 4*sigma_bin + 2), counted from the
kernel's source.  vertex_epilogue_kernel reads the slab partials, v, f,
the CSR ([V+1] offsets, 3*Fv entries, int32) and the gradient, writes
it, and does 18 operations an entry and 6 a slab past the first."""

from gpu_bench.harness import roofline

KERNELS = ("face_sums_kernel", "vertex_epilogue_kernel")
OPS_PER_RAY, GN_OPS_PER_RAY, EPI_OPS_PER_ENTRY = 94, 23, 18
THREADS, BLOCKS_PER_SM = 128, 8


def slabs(Lc, F, spt, sms):
    """The kernel's slab count: the fewest slabs whose grid (face tiles x
    slabs) has BLOCKS_PER_SM blocks a SM."""
    tiles = -(-F // (THREADS // spt if spt < THREADS else 1))
    slab = Lc // min(Lc, max(1, -(-BLOCKS_PER_SM * sms // tiles)))
    return -(-Lc // slab)


def chunk(r):
    if not r["fused_bwd"]:
        return None
    Lc, F, V, spt = r["Lc"], r["F"], r["V"], r["spt"]
    R = Lc * F * spt
    G = 4 * r["sigma_bin"] + 2
    normal = 12 * R if r["vn"] else 12 * F
    k2_bytes = (33 * R + normal + 4 * F + 12 * Lc + 4 * Lc * r["B"]
                + 8 * r["refine"] * G + 48 * F)
    k2_ops = R * (OPS_PER_RAY + 4 * G + (GN_OPS_PER_RAY if r["gn"] else 0))
    n = slabs(Lc, F, spt, r["sms"])
    entries = 3 * r["Fv"]
    epi_bytes = 48 * n * F + 12 * V + 24 * F + 4 * (V + 1) + 4 * entries \
        + 24 * V
    epi_ops = entries * (EPI_OPS_PER_ENTRY + 6 * (n - 1))
    return (roofline.bound_seconds(k2_ops, k2_bytes)
            + roofline.bound_seconds(epi_ops, epi_bytes))


def read(ctx):
    return roofline.share(ctx, KERNELS, "inverse", chunk)
