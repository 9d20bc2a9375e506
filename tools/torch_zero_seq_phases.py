#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 48-50 alone: ZeRO's memory scaling
(config 4 through ``fleet`` at sharding 2, ZeRO stages 1-3), the
sequence cut inside ``ParallelEngine`` (its cross-rank check with four
planted faults, then config 4 at ``sep_degree`` 2) and the sharded
checkpoint (``chip_smoke.zero_seq_phases``), after phase 44 (config 4 at
world size 1, whose peak memory phase 48's stage 3 must stay below),
with the checks of the whole smoke; then rows 2-5 at the sequence cut's
shapes (row 2 at ``[1024, 2304]``, rows 3-5 at Ulysses' ``[4, 512, 9,
128]`` with a ragged keep-mask), held and timed as the smoke holds them.

Run from the repo root::

    python3 tools/torch_zero_seq_phases.py [--out FILE]

Builds every kernel (``ops/cuda/build.py``), turns TF32 off in matmuls
and cuDNN as ``chip_smoke.main`` does, runs phase 44 and then phases
48-50, prints each one's result as a JSON line, then the card's name and
power limit. ``--out`` also writes all of it as one JSON object. Exits 1
when a check fails and 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_zero_seq_phases: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    t0 = time.perf_counter()
    build.build_all()
    out = {"card": card, "seconds": {"build": time.perf_counter() - t0}}
    t0 = time.perf_counter()
    out["ernie_fleet"] = cs.ernie_fleet_phase(dev)
    out["seconds"]["ernie_fleet"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (out["zero_memory_scaling"], out["ernie_fleet_sp"],
     out["sharded_checkpoint"]) = cs.zero_seq_phases(dev, out["ernie_fleet"])
    out["seconds"]["phases_48_50"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["layer_norm_sp"] = [
        cs.train_layer_norm_case(
            dev, cs.ERNIE_BATCH * cs.ERNIE_SEQ // cs.SQ_RANKS,
            cs.ERNIE_HIDDEN, dt)
        for dt in (torch.bfloat16, torch.float32)]
    out["flash_ulysses"] = cs.flash_timing(dev, cs.ULYSSES_ATTN,
                                           ragged=True)
    out["seconds"]["kernels"] = time.perf_counter() - t0
    cs.log(json.dumps({"seconds": out["seconds"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"torch_zero_seq_phases: {e}", file=sys.stderr)
        sys.exit(1)
