"""A kernel's share of its roofline: the least time the card could take
for the work of every launch in the traced segment (the larger of its
operations over the fp32 peak and its bytes over the HBM peak, each
input byte read once and each output byte written once), over the
device time of the kernels that did it.  On more than one card the
formula stays: the kernels' seconds summed over every card, against the
bound of every chunk that any card ran, so a share reads as one card's
would if the same chunks ran on one card."""

from . import trace

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
# limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def share(ctx, kernels, kind, per_chunk):
    """100 * the sum over the chunks of the ``kind`` renders of
    per_chunk(shape) (a chunk's bound in seconds, None where the kernels
    do not run) / the kernels' device seconds; None where the segment
    ran none of them."""
    if not ctx.events:
        return None
    device_s = trace.kernel_seconds(ctx.events, kernels)
    shapes = [r for r in ctx.renders if r["kind"] == kind]
    if device_s <= 0 or not shapes:
        return None
    bound = sum(-(-r["L"] // r["Lc"]) * per_chunk(r)
                for r in shapes if per_chunk(r) is not None)
    return 100.0 * bound / device_s if bound else None
