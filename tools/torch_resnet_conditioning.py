#!/usr/bin/env python3
"""How well-conditioned the seeded f32 ResNet-50 step is, on one card.

For each configuration (depth cut to the first ``blocks`` bottlenecks of
each stage or full depth, batch, image size) it runs
``chip_smoke.resnet_reference_readings``: the first step's gradients on
the kernel path, the plain path (twice) and float64, and three Momentum
steps of the kernel path and of the plain path through
``ParallelEngine``, in f32 with cuDNN deterministic and TF32 off. Prints
the card's name and power limit, then one JSON object per configuration:
the per-parameter gradient gaps (worst and median, relative to the
float64 gradient) and the largest differences of the losses, parameters
and running statistics after the steps. ``chip_smoke.py`` holds the two
configurations it checks; this sweep shows why those two.

    python3 tools/torch_resnet_conditioning.py
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (blocks per stage or None for full depth, batch, image size)
CONFIGS = ((None, 8, 64), (None, 8, 128), (None, 8, 224), (None, 16, 224),
           (1, 4, 64), (1, 8, 64), (1, 8, 128), (1, 8, 224), (1, 32, 64),
           (2, 8, 64))


def main() -> int:
    import chip_smoke as smoke
    from paddle1_tpu_torch.ops.cuda import build
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(smoke.card_line(), flush=True)
    build.build_all()
    for blocks, batch, img in CONFIGS:
        r = smoke.resnet_reference_readings(dev, batch, img, blocks=blocks,
                                            steps=smoke.REF_STEPS)
        r.pop("launches_kernel")
        r.pop("launches_plain")
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
