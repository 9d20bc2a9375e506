#!/usr/bin/env python3
"""How far the batch-norm kernels move ResNet-50's f32 first-step
gradient, on one CUDA card.

Run from the repo root::

    python3 tools/torch_resnet_grad_gap.py [--root DIR]

Builds the ResNet-50 of ``chip_smoke.py``'s reference check at its depth
cut (full width, one bottleneck per stage, 17 batch norms, batch 32 x 3 x
64 x 64, seeded weights and data, cuDNN deterministic, no TF32) and
prints its first-step gradient gaps (``chip_smoke.rn_grad_gaps``): the
kernel path against the plain path (``fused_bn``/``fused_bn_bwd`` never)
and each against float64, per parameter relative to its float64 gradient
norm, the worst parameter and the median. The smoke holds the kernel path
within 1e-3 of the plain path there; ``--root DIR`` imports
``paddle1_tpu_torch`` from another copy of the repo, so that two batch-norm
kernels' summation orders can be compared on one card. The last line of
stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_resnet_grad_gap: no CUDA card", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import paddle1_tpu_torch
    from paddle1_tpu_torch.vision.models import resnet50
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cut = cs.RN_REF_CUT
    model = resnet50(device=dev,
                     generator=torch.Generator().manual_seed(cs.SEED + 8))
    for i in range(1, 5):
        name = f"layer{i}"
        setattr(model, name, getattr(model, name)[:cut["blocks"]])
    rng = np.random.default_rng(cs.SEED + 8)
    batch, img = cut["batch"], cut["img"]
    data = {"x": torch.from_numpy(rng.standard_normal(
                (batch, 3, img, img)).astype(np.float32)).to(dev),
            "y": torch.from_numpy(rng.integers(0, 1000, (batch,))).to(dev)}
    print(json.dumps({"card": cs.card_line(),
                      "package": os.path.dirname(paddle1_tpu_torch.__file__),
                      **cut, **cs.rn_grad_gaps(model, data)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
