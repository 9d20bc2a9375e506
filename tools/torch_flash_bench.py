#!/usr/bin/env python3
"""Time the port's flash-attention kernels alone on one CUDA card.

Run from the repo root (or from a copy of the repo whose kernels differ,
to compare builds on one card, in turns)::

    python3 tools/torch_flash_bench.py [--shape B N H D] [--causal] [--reps R]

Builds the kernels from this checkout's sources, prints the card, each
tensor-core flash kernel's HMMA count, registers and spills, holds the
bf16 forward, dK/dV and dQ passes to their plain versions (one bf16 rounding
step + 1e-4, ``chip_smoke.py``'s FLASH_BF16_ABS) on the inputs it times,
then times the forward, dK/dV and dQ kernels by CUDA-graph replay over 4
input sets in turn (all keys kept), beside their bounds. One JSON line on
stdout. Default shape: BERT-base's attention at batch 128 (bf16
``[128, 128, 12, 64]``).
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=list(cs.BERT_ATTN),
                    metavar=("B", "N", "H", "D"))
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.ops import flash_attention as fa
    from paddle1_tpu_torch.ops import flash_attention_bwd as fb
    from paddle1_tpu_torch.ops.cuda import build
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    sass = cs.tensor_core_report(build, build.build_all())
    shape = tuple(args.shape)
    scale = 1.0 / shape[-1] ** 0.5
    sets, _, keep = cs.flash_case(dev, torch.bfloat16, cs.SEED + 4, n_sets=4,
                                  shape=shape)
    fwd = [fa.flash_fwd(q, k, v, scale, args.causal, keep)
           for q, k, v, _ in sets]
    deltas = [(do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
              for (_, _, _, do), (o, _) in zip(sets, fwd)]
    q, k, v, do = sets[0]
    ro, rl = fa.flash_attention_ref(q, k, v, scale, args.causal, keep)
    # the plain backward's own delta, from its own output
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, args.causal,
                              keep)
    dq = fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, args.causal, keep)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, ro, rl, do, scale, args.causal,
                                  keep)
    excess = {"fwd": cs.bf16_excess(fwd[0][0], ro),
              "dkv": max(cs.bf16_excess(dk, rk), cs.bf16_excess(dv, rv)),
              "dq": cs.bf16_excess(dq, rq)}
    ok = all(e <= cs.FLASH_BF16_ABS for e in excess.values())
    t = {"fwd": cs.graph_time_ms([lambda s=s: fa.flash_fwd(
        s[0], s[1], s[2], scale, args.causal, keep) for s in sets],
        reps=args.reps)}
    for name, fn in (("dkv", fb.flash_bwd_dkv), ("dq", fb.flash_bwd_dq)):
        t[name] = cs.graph_time_ms([lambda s=s, f=f, dl=dl, fn=fn: fn(
            s[0], s[1], s[2], s[3], f[1], dl, scale, args.causal, keep)
            for s, f, dl in zip(sets, fwd, deltas)], reps=args.reps)
    bounds = cs.flash_bounds(q, keep)
    print(json.dumps({
        "card": card, "shape": list(shape), "dtype": "bf16",
        "causal": args.causal, "ms": t,
        "bound_ms": {k_: b[0] for k_, b in bounds.items()},
        "bf16_excess": excess, "within_tolerance": ok, "sass": sass}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
