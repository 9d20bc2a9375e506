#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s generation phases alone on one CUDA card: phase
2 (rows 1-2 against their plain versions, the float16 cases included),
phase 3 (phase 3's ten staggered requests, whose streams phase 37 holds
the other engines to), then phases 36 (the float16 arms), 37 (the decode
economics: speculation, int8, resume, preemption, chaos) and 38 (the
batch ``Server`` over ResNet-50), with the checks of the whole smoke.

Run from the repo root::

    python3 tools/torch_gen_phases.py [--out FILE]

Builds every kernel (``ops/cuda/build.py``), turns TF32 off in matmuls
and cuDNN as ``chip_smoke.main`` does, runs the phases in the smoke's
order and prints each one's result as a JSON line, then the card's name
and power limit and the phases' seconds. ``--out`` also writes all of it
as one JSON object. Exits 1 when a check fails and 2 without a card.
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
        print("torch_gen_phases: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    build.build_all()
    out = {"card": card}
    kernels = cs.kernel_phase(dev)
    out["kernels_f16"] = {k: kernels[k] for k in ("paged_attention_f16",
                                                  "layer_norm_f16")}
    lm, eng, reqs, outs, launches, steps = cs.serving_phase(dev)
    del lm, eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["gen_f16"] = cs.gen_f16_phase(dev, reqs)
    out["decode_economics"] = cs.decode_economics_phase(dev, reqs, outs)
    out["resnet_server"] = cs.resnet_server_phase(dev)
    out["phases_36_38_s"] = time.perf_counter() - t0
    cs.log(json.dumps({"phases_36_38_s": out["phases_36_38_s"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"torch_gen_phases: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
