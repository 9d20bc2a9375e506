#!/usr/bin/env python3
"""Time the row-softmax kernel against ``torch.softmax`` on one CUDA card.

Run from the repo root::

    python3 tools/torch_softmax_bench.py [--shape ROWS H] [--rounds 5]

Builds the softmax kernel from the sources of the tree it imports and
times it and ``torch.softmax`` (last axis) on the same bf16 inputs,
alternating kernel and library ``--rounds`` times, each round a CUDA-graph
replay between CUDA events over 4 input sets in turn
(``chip_smoke.py``'s ``graph_time_ms``). The default shape is LeNet's
prediction, ``[64, 10]``, the one the eager main path launches, where a
call is about one launch and its graph gap. Prints each round's times,
and the median and spread (max - min) of each, as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=2, default=[64, 10])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_softmax_bench: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.ops import softmax as psm
    rows, h = args.shape
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    xs = [(torch.randn(rows, h, device="cuda", generator=g) * 4).to(
        torch.bfloat16) for _ in range(4)]
    for x in xs:
        torch.testing.assert_close(psm.softmax_fwd(x).float(),
                                   torch.softmax(x, dim=-1).float(),
                                   rtol=2.0 ** -7, atol=1e-5)
    times = {"kernel": [], "torch.softmax": []}
    for _ in range(args.rounds):
        times["kernel"].append(cs.graph_time_ms(
            [lambda x=x: psm.softmax_fwd(x) for x in xs]))
        times["torch.softmax"].append(cs.graph_time_ms(
            [lambda x=x: torch.softmax(x, dim=-1) for x in xs]))
    print(json.dumps({
        "card": cs.card_line(), "shape": [rows, h], "dtype": "bf16",
        "rounds_ms": times,
        "median_ms": {k: statistics.median(v) for k, v in times.items()},
        "spread_ms": {k: max(v) - min(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
