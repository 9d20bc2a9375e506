#!/usr/bin/env python3
"""Time the port's batch-norm kernels alone on one CUDA card.

Run from the repo root::

    python3 tools/torch_bn_bench.py [--root DIR]
        [--step [--kernel train_fwd|norm_bwd|moments]]

Builds the kernels from the sources of the tree it imports and times the
five of the fused batch-norm family (the training forward and the
training backward, each one cooperative launch, the given-statistics
forward and backward, and the local moments, the last two one launch
each) at ResNet-50's batch-norm
shapes at 32 images a card
(``chip_smoke.py``'s ``BN_SHAPES``: the stem, layers 2, 3 and 4) in bf16,
by CUDA-graph replay over 4 input sets in turn, beside their plain
versions, ``F.batch_norm`` (``torch.batch_norm_stats`` for the moments)
on the same rows as a channels-last ``[N, C, H, W]`` tensor, and their
bounds; the moments kernel is also held to its plain version
(``chip_smoke.py``'s ``bn_timing`` and ``moments_phase``). ``plans``
gives the cooperative kernels' resident rows per chunk at each shape,
where the imported tree has their plans. ``--step`` times one kernel
alone instead (``--kernel``: the training forward, the default; the
given-statistics backward; the local moments; bf16, identity, no
residual) at every distinct batch-norm shape of a ResNet-50 step at 32
images (``tools/torch_train_profile.py``'s ``resnet50_bn_shapes``: 12
shapes, 53 batch norms) and sums them by their counts: its device time a
step by CUDA-graph replay, beside the step's bound for that kernel
(``bn_bound_ms_per_step``: 2, 3 and 1 bytes an element of x moved once,
for the forward, the backward and the moments). ``--root DIR``
imports ``paddle1_tpu_torch`` from another copy of the repo (say an older
commit unpacked under ``_archive/``), so that two builds can be timed in
turns on one card. The last line of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tools.torch_train_profile import (bn_bound_ms_per_step,  # noqa: E402
                                       resnet50_bn_shapes)

# --kernel: the wrapper call on one input set (x, gamma, beta, residual,
# mean, var, dy) of cs.bn_inputs, and the kind bn_bound_ms_per_step
# bounds it by
STEP_KERNELS = {
    "train_fwd": (lambda fbn, fbb, s: fbn._train_fwd(
        s[0], s[1], s[2], None, 1e-5, "identity"), "train_fwd"),
    "norm_bwd": (lambda fbn, fbb, s: fbb.norm_bwd(
        s[0], s[1], s[4], s[5], None, s[6], 1e-5, "identity"), "norm_bwd"),
    "moments": (lambda fbn, fbb, s: fbn._moments_fwd(s[0]), "moments"),
}


def step_timing(dev, kernel="train_fwd"):
    """{"step_ms", "bound_ms", "shapes": {"RxC": {"ms", "count"}}}: one
    kernel (bf16, identity, no residual) at each distinct shape of a
    ResNet-50 step, over 4 input sets in turn, by CUDA-graph replay,
    summed by the shapes' counts, beside the step's bound for it."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    call, kind = STEP_KERNELS[kernel]
    shapes = resnet50_bn_shapes(cs.RN_BATCH)
    out = {}
    for rows, c in sorted(set(shapes)):
        sets = cs.bn_inputs(dev, rows, c, torch.bfloat16, cs.SEED + 9,
                            n_sets=4)
        ms = cs.graph_time_ms([lambda s=s: call(fbn, fbb, s) for s in sets])
        out[f"{rows}x{c}"] = {"ms": ms, "count": shapes.count((rows, c))}
        del sets
        torch.cuda.empty_cache()
    return {"step_ms": sum(v["ms"] * v["count"] for v in out.values()),
            "bound_ms": bn_bound_ms_per_step(cs.RN_BATCH)[kind],
            "shapes": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--kernel", choices=sorted(STEP_KERNELS),
                    default="train_fwd", help="the kernel --step times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bn_bench: no CUDA card", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import paddle1_tpu_torch
    dev = torch.device("cuda", 0)
    if args.step:
        print(json.dumps({
            "card": cs.card_line(),
            "package": os.path.dirname(paddle1_tpu_torch.__file__),
            "kernel": args.kernel, "dtype": "bf16",
            **step_timing(dev, args.kernel)}))
        return 0
    try:
        times = cs.bn_timing(dev)
        _, moments = cs.moments_phase(dev)
    except cs.SmokeFailure as e:
        print(f"torch_bn_bench: {e}", file=sys.stderr)
        return 1
    times["fused_bn_moments"] = moments
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    print(json.dumps({
        "card": cs.card_line(),
        "package": os.path.dirname(paddle1_tpu_torch.__file__),
        "dtype": "bf16", "shapes": [list(s) for s in cs.BN_SHAPES],
        "kernels": {name: [{"shape": t["shape"], **{k: t[k] for k in keys}}
                           for t in cases]
                    for name, cases in times.items()},
        "plans": {name: [{"shape": t["shape"], **{
            k: t["plan"][k] for k in ("chunks", "rows_per_chunk",
                                      "resident")}} for t in cases]
                  for name, cases in times.items() if "plan" in cases[0]},
        "detail": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
