#!/usr/bin/env python3
"""Time the port's paged-attention kernel alone on one CUDA card.

Run from the repo root::

    python3 tools/torch_paged_bench.py [--root DIR]

Builds the kernel from the sources of the tree it imports, holds it to its
plain version (2e-5 abs in f32), checks that a repeat is bit-identical and
that a CUDA graph of the call replays as it ran eagerly, and times the
kernel and its plain version by CUDA-graph replay over the 12 layers'
pools in turn, beside the bound, at the serving path's decode shape (16
slots, q ``[16, W, 8, 64]``, pools ``[513, 16, 8, 64]``, table
``[16, 32]``): W = 1 and W = 4 over f32 pools and W = 1 over bf16 pools
with random slot lengths, one slot at 496 among 15 shorter than one split,
and every slot long (``chip_smoke.py``'s ``paged_phase``). ``--sweep``
times the kernel alone instead with every slot at one length (no visible
key, then 1, 32, 64, 151, 301 and 512 keys at W = 1 over f32 pools), so
that the fixed cost of a launch, of one CTA's chain and of the merge can
be read off, and at two mixes of lengths (``paged_bases``' random and
skewed ones, drawn from their own seeds). ``--root DIR``
imports ``paddle1_tpu_torch`` from another copy of the repo (say an older
commit unpacked under ``_archive/``), so that two builds can be timed in
turns on one card. The last line of stdout is one JSON object.
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


SWEEP_BASES = (-1, 0, 31, 63, 150, 300, 511, "random", "skewed")


def sweep_bases(b):
    """The 16 slots' lengths before the window for one sweep entry."""
    if b == "random":
        return cs.paged_bases(np.random.default_rng(cs.SEED), 1, b)
    if b == "skewed":
        return cs.paged_bases(np.random.default_rng(cs.SEED + 3), 1, b)
    return np.full(cs.SLOTS, b, np.int32)


def sweep(dev):
    """{base: {"ms", "max_abs_err"}}: the kernel alone by CUDA-graph
    replay over 12 layers' f32 pools, the 16 slots at ``sweep_bases``,
    W = 1, a shuffled [16, 32] table; held to its plain version (a row
    that sees no key to 0)."""
    from paddle1_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(cs.SEED)
    hd = cs.D_MODEL // cs.HEADS
    mpps = cs.MAX_SEQ // cs.PAGE
    pools = [tuple(torch.randn(cs.SLOTS * mpps + 1, cs.PAGE, cs.HEADS, hd,
                               device=dev) for _ in range(2))
             for _ in range(cs.LAYERS)]
    table = torch.from_numpy(rng.permutation(
        np.arange(1, cs.SLOTS * mpps + 1)).astype(np.int32).reshape(
            cs.SLOTS, mpps)).to(dev)
    q = torch.randn(cs.SLOTS, 1, cs.HEADS, hd, device=dev)
    out = {}
    for b in SWEEP_BASES:
        base = torch.from_numpy(sweep_bases(b)).to(dev)
        got = pa.paged_attention(q, *pools[0], table, base)
        want = pa.paged_attention_ref(q, *pools[0], table, base)
        seen = base >= 0
        err = max(float((got - want)[seen].abs().max()) if seen.any()
                  else 0.0, float(got[~seen].abs().max()) if
                  (~seen).any() else 0.0)
        cs.check(err <= cs.PA_TOL, f"paged_attention base {b}: {err}")
        out[b] = {"ms": cs.graph_time_ms([
            lambda kp=kp, vp=vp: pa.paged_attention(q, kp, vp, table, base)
            for kp, vp in pools]), "max_abs_err": err}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_bench: no CUDA card", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import paddle1_tpu_torch
    dev = torch.device("cuda", 0)
    try:
        result = {"sweep": sweep(dev)} if args.sweep else {
            "cases": cs.paged_phase(dev, np.random.default_rng(cs.SEED))}
    except cs.SmokeFailure as e:
        print(f"torch_paged_bench: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"card": cs.card_line(),
                      "package": os.path.dirname(paddle1_tpu_torch.__file__),
                      **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
