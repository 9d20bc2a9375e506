#!/usr/bin/env python3
"""Data-parallel ResNet-50 across the cards of one host, over NCCL.

``chip_smoke.py``'s cross-rank check (phase 13) with one rank per card:
for each count in ``--ranks`` (default: every card), that many ranks of
``ParallelEngine`` on ``build_mesh(dp=ranks)``, spawned by ``distributed.spawn`` and joined over
NCCL, take three f32 Momentum steps of ResNet-50 at full width cut to one
bottleneck per stage on a global batch of 32 x 3 x 64 x 64, and are held
to the world-size-1 engine on the whole batch within 1e-4 (losses,
parameters, running statistics), the ranks identical to each other.
Prints the card line and one JSON object; exits non-zero on a failed
check or a failed rank.

    python3 tools/torch_dp_check.py [--ranks N [N ...]]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--ranks", type=int, nargs="+", default=None,
                    help="rank counts to check, one rank per card "
                         "(default: every card)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dp_check: no CUDA card", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    counts = args.ranks or [cards]
    if not all(2 <= n <= cards for n in counts):
        print(f"torch_dp_check: rank counts {counts} must lie in 2..{cards} "
              "(one card per rank)", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle1_tpu_torch.ops.cuda import build
    cs.log(cs.card_line())
    build.build_all()     # before the ranks start: they only load
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.cross_rank_check(torch.device("cuda", 0),
                        runs=[("nccl", False, n) for n in counts])
    return 0


if __name__ == "__main__":
    sys.exit(main())
