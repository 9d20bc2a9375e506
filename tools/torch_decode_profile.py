#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one card.

Builds the serving path of ``chip_smoke.py`` (``CausalLM`` at the README
width — vocab 32000, d_model 512, 8 heads, 12 layers, max_seq 512 —
seeded random weights, paged KV, page 16, 16 slots), prefills every slot
with a prompt of ``--prompt`` tokens, then:

* times ``--steps`` decode steps with all slots active (host clock
  around ``GenerationEngine.decode``, which ends in the token readback);
* profiles ``--profile-steps`` more with ``torch.profiler`` (CPU + CUDA
  activities) and reports the device's busy time per step (sum of kernel
  times), its idle share, and the kernels by total device time.

Prints one JSON object.

    python3 tools/torch_decode_profile.py [--steps 40] [--profile-steps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _kernel_times(prof):
    """``{kernel name: (total us, calls)}`` over the device-side kernel
    events of a profile (op rows, which also carry their kernels' device
    time, are left out so nothing is counted twice)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us, n = out.get(e.name, (0.0, 0))
        out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--profile-steps", type=int, default=10)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.serving import CausalLM, GenerationEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(args.seed)
    lm = CausalLM(32000, d_model=512, nhead=8, dim_feedforward=128,
                  num_layers=12, max_seq=512, generator=gen)
    eng = GenerationEngine(lm, slots=16, max_seq=512, paged=True,
                           page_size=16, prefix_cache=0)
    eng.warm_up()
    rng = np.random.default_rng(args.seed)
    for s in range(eng.slots):
        eng.prefill(s, rng.integers(3, 32000, args.prompt).astype(np.int32),
                    0.8 if s % 2 else 0.0, 40 if s % 2 else 0, s)
    active = np.ones([eng.slots], bool)
    for _ in range(3):
        eng.decode(active)
    torch.cuda.synchronize()

    host_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.decode(active)
        host_ms.append((time.perf_counter() - t0) * 1e3)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            eng.decode(active)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((name, us, n) for name, (us, n)
                      in _kernel_times(prof).items()), key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    n = args.profile_steps
    per_step_busy_ms = busy_us / 1e3 / n if kernels else None
    step_ms = prof_wall_ms / n
    ours = {name: sum(k[1] for k in kernels if name in k[0]) / 1e3 / n
            for name in ("paged_attention", "layer_norm_warp_kernel")}
    result = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0],
        "slots_active": int(active.sum()), "prompt": args.prompt,
        "decode_step_ms_p50": float(np.percentile(host_ms, 50)),
        "decode_step_ms_mean": float(np.mean(host_ms)),
        "tokens_per_s_full_batch": eng.slots / (np.mean(host_ms) / 1e3),
        "profiled_step_ms": step_ms,
        "device_busy_ms_per_step": per_step_busy_ms,
        "device_idle_share": (None if per_step_busy_ms is None
                              else 1.0 - per_step_busy_ms / step_ms),
        "kernel_launches_per_step": (sum(k[2] for k in kernels) / n
                                     if kernels else None),
        "our_kernels_ms_per_step": ours,
        "top_kernels": [{"name": k[0][:120], "ms_per_step": k[1] / 1e3 / n,
                         "calls_per_step": k[2] / n} for k in kernels[:15]],
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
