"""Traffic kind ``descent_sharded``: the ``descent`` kind's closed loop
with the sources sharded, as one process over the cell's cards.  Each
iteration renders through ``shard.sharded_inverse_render`` over a source
mesh of one shard a device of the cell's ``devices`` (``[cuda:0] * 4``
is four virtual shards of one card); the GT comes from
``sharded_render_transient`` at refine 1.  The transient and the gradient come back on the first card,
where the update runs.  The shards sample with the sources' global
indices, so the sampling keys are the unsharded descent's.

Traffic keys: those of ``descent``.

The timed path renders through ``shard.sharded_inverse_render``
(``ENTRY``); besides the descent's faults, the tests leave the last
shard out of the exchange (``exchange_left_out``).
"""

from __future__ import annotations

import math

from nlos_surface_optimization_torch.parallel import shard

from gpu_bench.drivers import descent
from gpu_bench.harness.recorder import render_shape

ENTRY = (shard, "sharded_inverse_render")
FAULTS = descent.FAULTS + ("exchange_left_out",)
TEST_SECONDS = descent.TEST_SECONDS
tiny = descent.tiny


class Driver(descent.Driver):
    """Fixed-topology descent, one source shard a device of the cell's
    ``devices``."""

    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        super().__init__(config, traffic, seed, devices)
        self.dmesh = shard.make_source_mesh(self.devices)

    def render_gt(self, gt_mesh, cfg_gt):
        return shard.sharded_render_transient(
            gt_mesh, self.lighting, self.lnormal, cfg_gt, self.key,
            self.dmesh, refine=1, alpha=self.c.get("gt_alpha"))

    def inverse(self, m):
        return shard.sharded_inverse_render(
            m, self.gt, self.weight, self.lighting, self.lnormal, self.cfg,
            self.key, self.dmesh, alpha=self.c.get("alpha"))

    def render_shapes(self, m):
        """One render a shard, of its ceil(L / shards) sources."""
        Ls = math.ceil(self.lighting.shape[0] / self.dmesh.size)
        return [render_shape("inverse", m, self.cfg, Ls, m.f.shape[0])
                ] * self.dmesh.size
