#!/usr/bin/env python3
"""The flagship inverse render sharded over the cards of one host, one
NCCL process a card, against one card.

    python3 scripts/shard_across_cards.py

Builds the kernels, makes chip_smoke.py's shard inputs (the flagship: a
3,042-face flat plane against the GT transient of its height field, 64×64
scan, 20,000 samples, 1,200 bins, chunks of 64) and runs
``sharded_inverse_render`` through ``chip_smoke.shard_ranks``: with one
rank, then with one rank a card.  Each rank runs the call once, then
``chip_smoke.SHARD_REPS`` timed times (the speed-up compares the
medians).  The transient over every card must equal the one-rank
transient bit for bit and the gradient must agree within
``chip_smoke.SHARD_GRAD_TOL`` of max|g|.  Prints one JSON line a run
with the card's name and power limit, then {"ok": true, ...}; exits
nonzero where a check fails or there are fewer than two cards.
"""

import json
import os
import statistics
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main() -> int:
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"shard_across_cards: {cards} CUDA card(s); needs two or more",
              file=sys.stderr)
        return 2
    from nlos_surface_optimization_torch import _cuda

    chip_smoke.CARD = chip_smoke.card_line()
    chip_smoke.emit("build", seconds=_cuda.build_all())
    v, f, plane = chip_smoke.flagship_scene()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        chip_smoke.shard_inputs(torch.device("cuda", 0), v, f, plane, inputs)
        runs = {}
        for world in (1, cards):
            runs[world] = chip_smoke.shard_ranks(
                world, inputs, os.path.join(tmp, f"out{world}.pt"))
    one, all_ = runs[1], runs[cards]
    dev_g = float((all_["g"] - one["g"]).abs().max() / one["g"].abs().max())
    for world, r in runs.items():
        chip_smoke.emit("shard_cards", world=world, seconds=r["seconds"],
                        first_seconds=r["first_seconds"],
                        repeat_equal=r["repeat_equal"], summary=r["summary"])
    chip_smoke.emit("shard_cards_check", cards=cards,
                    transient_equal=bool(torch.equal(all_["t"], one["t"])),
                    grad_max_dev_over_max=dev_g,
                    speedup=statistics.median(one["seconds"])
                    / statistics.median(all_["seconds"]))
    chip_smoke.require(torch.equal(all_["t"], one["t"]),
                       f"{cards} cards: the transient differs from one's")
    chip_smoke.require(dev_g <= chip_smoke.SHARD_GRAD_TOL,
                       f"{cards} cards: gradient {dev_g:.3g} of max|g|")
    chip_smoke.require(one["repeat_equal"] and all_["repeat_equal"],
                       "a rank's repeated calls differ")
    print(chip_smoke.CARD, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
