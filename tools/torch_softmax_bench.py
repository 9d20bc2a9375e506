#!/usr/bin/env python3
"""Time the row-softmax kernel (row 7) against ``torch.softmax`` and an
earlier revision's kernel on one CUDA card.

Run from the repo root::

    python3 tools/torch_softmax_bench.py [--shapes R H [R H ...]]
        [--dtype bfloat16 float32] [--rounds 5] [--reps 20]
        [--parent REV|FILE|none] [--sweep]

Builds this tree's kernel, and the one of ``--parent`` (a git revision,
read with ``git show REV:paddle1_tpu_torch/ops/cuda/softmax.cu``, or a
``.cu`` file, for a copy of the repo without git; the parent's entry
point takes ``(x, y, rows, h, dtype, stream)``) through
``ops/cuda/build.py``. At each shape (``chip_smoke.SM_SHAPES`` by
default) and dtype it holds this tree's kernel to its plain version
(``chip_smoke.SM_TOL`` in f32, one rounding step in bf16 / f16), then
times kernel, ``torch.softmax`` (last axis) and parent in alternating
rounds (that order, then the reverse), every one the same way: captured
once into a CUDA graph over enough input sets to leave the L2 cache and
replayed ``--reps`` times between CUDA events
(``chip_smoke.graph_time_ms``). It prints one JSON line per shape and
dtype: each round's ms, the median and spread (max - min) of each, the
kernel's plan and the bytes bound (x read once, y written once, over
3.35 TB/s).

``--sweep`` instead times this tree's kernel alone over its launch
settings (``ops/softmax.py``: ``NARROW_MAX``, ``FILL_LANES``,
``SCALAR_MAX``, ``NARROW_BLOCKS_PER_SM``, ``WIDE_BLOCKS_PER_SM``, one at
a time from the defaults), each held to the plain version first: one JSON line per setting, shape
and dtype, then the registers nvcc reported. The card's name and power
limit are in every line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle1_tpu_torch.ops import softmax as psm  # noqa: E402
from paddle1_tpu_torch.ops.cuda import build  # noqa: E402

SRC = "paddle1_tpu_torch/ops/cuda/softmax.cu"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
# the settings swept, each alone over its values
SWEEP = {"NARROW_MAX": (512, 1024), "FILL_LANES": (8192, 32768, 131072),
         "SCALAR_MAX": (0, 64), "NARROW_BLOCKS_PER_SM": (8, 16, 32, 64, 256),
         "WIDE_BLOCKS_PER_SM": (1, 2)}


def sweep_settings():
    """Every setting to time: a dict of ``ops/softmax.py`` names."""
    return [{k: v} for k, vals in SWEEP.items() for v in vals]


def parent_kernel(spec: str):
    """The parent revision's softmax as a function of x (its entry point
    ``p1t_softmax_fwd(x, y, rows, h, dtype, stream)``), or None."""
    if spec == "none":
        return None
    if os.path.isfile(spec):
        path = os.path.abspath(spec)
    else:
        src = subprocess.run(["git", "show", f"{spec}:{SRC}"], cwd=ROOT,
                             capture_output=True, text=True, check=True)
        path = os.path.join(build.build_dir(), "softmax_parent.cu")
        os.makedirs(build.build_dir(), exist_ok=True)
        with open(path, "w") as f:
            f.write(src.stdout)
    build.load_file(path, "softmax_parent")
    fn = build.function("softmax_parent", "p1t_softmax_fwd",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 +
                        [ctypes.c_void_p])

    def run(x):
        y = torch.empty_like(x)
        rc = fn(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                psm._DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"parent kernel: CUDA error {rc}")
        return y
    return run


def inputs(rows: int, h: int, dtype):
    """Seeded inputs, enough sets to leave the 50 MB L2 between calls."""
    need = 2 * rows * h * torch.tensor([], dtype=dtype).element_size()
    n_sets = max(1, min(4, -(-200_000_000 // need)))
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 16)
    return [(torch.randn(rows, h, device="cuda", generator=g) * 4).to(dtype)
            for _ in range(n_sets)], need


def check(xs) -> float:
    """This tree's kernel against its plain version: the largest error
    (f32) or excess over one rounding step (bf16 / f16); fails beyond
    chip_smoke's tolerances."""
    worst = 0.0
    for x in xs:
        y, want = psm.softmax_fwd(x).float(), psm.softmax_ref(x).float()
        err = (y - want).abs()
        if x.dtype == torch.float32:
            worst = max(worst, float(err.max()))
            lim = cs.SM_TOL
        else:
            rel = cs.BF16_REL if x.dtype == torch.bfloat16 else cs.F16_REL
            worst = max(worst, float((err - rel * want.abs()).max()))
            lim = cs.BF16_ABS
        if worst > lim:
            raise SystemExit(f"kernel differs from its plain version by "
                             f"{worst} > {lim} at {list(x.shape)} {x.dtype}")
    return worst


def registers() -> dict:
    log = build.build_log("softmax") or ""
    return {m.group(1)[-70:]: int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?Used (\d+) registers", log,
        re.S)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", type=int, nargs="+",
                    default=[n for s in cs.SM_SHAPES for n in s])
    ap.add_argument("--dtype", nargs="+", choices=tuple(DTYPES),
                    default=["bfloat16"])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", default="HEAD")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_softmax_bench: no CUDA card", file=sys.stderr)
        return 2
    if len(args.shapes) % 2:
        ap.error("--shapes takes pairs ROWS H")
    shapes = list(zip(args.shapes[::2], args.shapes[1::2]))
    card = cs.card_line()
    parent = None if args.sweep else parent_kernel(args.parent)
    for dname in args.dtype:
        for rows, h in shapes:
            xs, need = inputs(rows, h, DTYPES[dname])
            head = {"card": card, "shape": [rows, h], "dtype": dname,
                    "bound_ms": 1e3 * need / cs.HBM_BYTES_PER_S,
                    "input_sets": len(xs)}
            if args.sweep:
                for setting in sweep_settings():
                    default = {k: getattr(psm, k) for k in setting}
                    for k, v in setting.items():
                        setattr(psm, k, v)
                    err = check(xs)
                    times = [cs.graph_time_ms(
                        [lambda x=x: psm.softmax_fwd(x) for x in xs],
                        args.reps) for _ in range(args.rounds)]
                    print(json.dumps({
                        **head, "setting": setting,
                        "plan": psm.plan(rows, h,
                                         xs[0].element_size())._asdict(),
                        "max_err": err,
                        "median_ms": statistics.median(times),
                        "spread_ms": max(times) - min(times)}), flush=True)
                    for k, v in default.items():
                        setattr(psm, k, v)
                del xs
                torch.cuda.empty_cache()
                continue
            err = check(xs)
            fns = {"kernel": psm.softmax_fwd,
                   "torch.softmax": lambda x: torch.softmax(x, dim=-1)}
            if parent is not None:
                fns["parent"] = parent
            times = {k: [] for k in fns}
            order = list(fns)
            for r in range(args.rounds):
                for k in (order if r % 2 == 0 else order[::-1]):
                    times[k].append(cs.graph_time_ms(
                        [lambda x=x, f=fns[k]: f(x) for x in xs], args.reps))
            print(json.dumps({
                **head,
                "plan": psm.plan(rows, h, xs[0].element_size())._asdict(),
                "max_err": err, "rounds_ms": times,
                "median_ms": {k: statistics.median(v)
                              for k, v in times.items()},
                "spread_ms": {k: max(v) - min(v) for k, v in times.items()}}),
                flush=True)
            del xs
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "registers": registers()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
