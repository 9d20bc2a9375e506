#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 46-47 alone: config 4 through ``fleet``
at ``pp_degree`` 2 with its cross-rank check and planted faults, and ring
and Ulysses attention at ERNIE's attention shape
(``chip_smoke.pipeline_phases``), after phase 44 (config 4 at world size
1, whose peak memory and parameter count phase 46 must stay below), with
the checks of the whole smoke.

Run from the repo root::

    python3 tools/torch_pipeline_phases.py [--out FILE]

Builds every kernel (``ops/cuda/build.py``), turns TF32 off in matmuls
and cuDNN as ``chip_smoke.main`` does, runs phase 44 and then phases
46-47, prints each one's result as a JSON line, then the card's name and
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
        print("torch_pipeline_phases: no CUDA card", file=sys.stderr)
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
    out["ernie_fleet_pp"], out["sequence_parallel"] = cs.pipeline_phases(
        dev, out["ernie_fleet"])
    out["seconds"]["phases_46_47"] = time.perf_counter() - t0
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
        print(f"torch_pipeline_phases: {e}", file=sys.stderr)
        sys.exit(1)
