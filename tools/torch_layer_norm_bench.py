#!/usr/bin/env python3
"""Time the port's LayerNorm kernel alone on one CUDA card.

Run from the repo root::

    python3 tools/torch_layer_norm_bench.py [--root DIR]

Builds the kernel from the sources of the tree it imports, holds it to its
plain version within one bf16 rounding step, and times the kernel, its
plain version and ``F.layer_norm`` by CUDA-graph replay over 4 input sets
in turn, beside the bound, at BERT-base's training shape, bf16
``[16384, 768]`` (``chip_smoke.py``'s ``train_layer_norm_case``).
``--root DIR`` imports ``paddle1_tpu_torch`` from another copy of the repo
(say an older commit unpacked under ``_archive/``), so that two builds can
be timed in turns on one card. The last line of stdout is one JSON object.
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
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_layer_norm_bench: no CUDA card", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import paddle1_tpu_torch
    try:
        case = cs.train_layer_norm_case(torch.device("cuda", 0))
    except cs.SmokeFailure as e:
        print(f"torch_layer_norm_bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"card": cs.card_line(),
                      "package": os.path.dirname(paddle1_tpu_torch.__file__),
                      **case}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
