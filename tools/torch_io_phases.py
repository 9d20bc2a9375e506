#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 34-35 alone on one CUDA card: ResNet-50
training fed by the DataLoader's worker processes with its exact checks
(``io_resnet_phase``), and eager LeNet on MNIST files through the
DataLoader (``io_lenet_phase``), with the checks of the whole smoke. Phases
9 (``resnet_phase``) and 15 (``lenet_phase``) run first, in the smoke's
order, so that the fed steps are read beside the staged ones of the same
run.

Run from the repo root::

    python3 tools/torch_io_phases.py [--out FILE]

Builds every kernel (``ops/cuda/build.py``), turns TF32 off in matmuls
and cuDNN as ``chip_smoke.main`` does, prints each phase's result as a
JSON line, then the card's name and power limit. ``--out`` also writes
all of it as one JSON object. Exits 1 when a check fails and 2 without a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_io_phases: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    build.build_all()
    out = {"card": card, "resnet": cs.resnet_phase(dev)}
    torch.cuda.empty_cache()
    out["lenet"] = cs.lenet_phase(dev)
    torch.cuda.empty_cache()
    out["io_resnet50"] = cs.io_resnet_phase(
        dev, out["resnet"]["step_ms_median"])
    torch.cuda.empty_cache()
    out["io_lenet"] = cs.io_lenet_phase(dev, out["lenet"]["step_ms_median"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"torch_io_phases: {e}", file=sys.stderr)
        sys.exit(1)
