"""Sharding of the renderer over the source (scan-point) axis.

Every shard holds the whole triangle mesh and renders a contiguous block
of scan points; the gradients are all-reduced over a torch.distributed
process group (NCCL between cards, gloo on the CPU).  Counter-based
sampling keys make the result independent of the shard count
(geometry/sampling.py).
"""

from .shard import (  # noqa: F401
    make_source_mesh,
    sharded_render_transient,
    sharded_inverse_render,
)
