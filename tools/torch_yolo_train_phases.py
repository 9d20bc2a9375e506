#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 39-42 alone on one CUDA card: rows 8-12
in float16 against their plain versions and timed (``bn_f16_phase``),
ResNet-50 under ``ParallelEngine(amp_dtype="float16")`` with its eval,
data-parallel and kernel-vs-plain checks (``resnet_f16_phase``), YOLOv3
training at 8 x 608² (``yolo_train_phase``) and its f32 kernel path
against the plain path (``yolo_train_reference_check``), and VGG16-BN
eval (``vgg_phase``), with the checks of the whole smoke.

Run from the repo root::

    python3 tools/torch_yolo_train_phases.py [--out FILE] [--phases 39 40 41 42]

Builds every kernel (``ops/cuda/build.py``), turns TF32 off in matmuls
and cuDNN as ``chip_smoke.main`` does, runs the chosen phases in the
smoke's order and prints each one's result as a JSON line, then the
card's name and power limit. ``--out`` also writes all of it as one JSON
object. Exits 1 when a check fails and 2 without a card.
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
    ap.add_argument("--phases", nargs="+", type=int,
                    default=[39, 40, 41, 42], choices=[39, 40, 41, 42])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_yolo_train_phases: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    build.build_all()
    out = {"card": card, "seconds": {}}
    for phase, key, run in (
            (39, "bn_f16", cs.bn_f16_phase),
            (40, "resnet50_f16", cs.resnet_f16_phase),
            (41, "yolov3_train", cs.yolo_train_phase),
            (41, "yolov3_train_reference", cs.yolo_train_reference_check),
            (42, "vgg16_bn_eval", cs.vgg_phase)):
        if phase not in args.phases:
            continue
        t0 = time.perf_counter()
        out[key] = run(dev)
        out["seconds"][key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
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
        print(f"torch_yolo_train_phases: {e}", file=sys.stderr)
        sys.exit(1)
