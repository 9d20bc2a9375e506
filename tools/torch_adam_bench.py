#!/usr/bin/env python3
"""Time the fused AdamW kernel (row 6) against ``torch.optim.AdamW(fused=
True)`` and an earlier revision's kernel on one CUDA card.

Run from the repo root::

    python3 tools/torch_adam_bench.py [--sizes bert ernie]
        [--dtypes float32 bfloat16] [--rounds 5] [--reps 10]
        [--parent REV|FILE|none] [--sweep]

Builds this tree's kernel, and the one of ``--parent`` (a git revision,
read with ``git show REV:paddle1_tpu_torch/ops/cuda/fused_adam.cu``, or a
``.cu`` file, for a copy of the repo without git) through
``ops/cuda/build.py``. For each parameter list (BERT-base's 110,106,428
elements in ``chip_smoke.bert_shapes()``' 206 tensors, ERNIE-1.5B's
1,637,101,122 in 398) and dtype of p and g (the moments f32) it holds
this tree's kernel to the plain version (rtol 1e-6, atol 1e-7, as
``chip_smoke.py``'s ``ADAM_RTOL``/``ADAM_ATOL``), then times the three in
alternating rounds (kernel, library, parent, then the reverse), every one
the same way: captured once into a CUDA graph and replayed ``--reps``
times between CUDA events (``chip_smoke.graph_time_ms``), so that no host
time shows; the library runs with ``capturable=True`` (its step count on
the card) and keeps its moments in the parameters' dtype, so in bf16 it
moves 14 B an element against the kernels' 22. It prints, as
one JSON line per list and dtype, each round's ms, the median and spread
(max - min) of each, and the bound: the bytes each element must move (p,
g, m1, m2 read once; p, m1, m2 written once: 28 B in f32, 22 in bf16)
over 3.35 TB/s.

``--sweep`` instead times this tree's kernel alone over its launch
settings (``CHUNK`` 8192-65536 elements, ``CTAS_PER_SM`` 2-8; each held
to the plain version at BERT-base first), one JSON line per setting and
list, then the registers nvcc reported.
The card's name and power limit are in every line.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle1_tpu_torch.ops import fused_adam as fa  # noqa: E402
from paddle1_tpu_torch.ops.cuda import build  # noqa: E402

SRC = "paddle1_tpu_torch/ops/cuda/fused_adam.cu"
BETA1, BETA2, EPS, DECAY = 0.9, 0.999, 1e-8, 0.01
SHAPES = {"bert": cs.bert_shapes, "ernie": cs.ernie_shapes}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SWEEP = {"chunk": (8192, 16384, 32768, 65536), "ctas_per_sm": (2, 4, 8)}


def parent_kernel(spec: str):
    """The parent revision's ``p1t_fused_adam`` (the one-CTA-a-chunk
    kernel's signature: no CTAs an SM), or None."""
    if spec == "none":
        return None
    if os.path.isfile(spec):
        path = os.path.abspath(spec)
    else:
        src = subprocess.run(["git", "show", f"{spec}:{SRC}"], cwd=ROOT,
                             capture_output=True, text=True, check=True)
        path = os.path.join(build.build_dir(), "fused_adam_parent.cu")
        os.makedirs(build.build_dir(), exist_ok=True)
        with open(path, "w") as f:
            f.write(src.stdout)
    build.load_file(path, "fused_adam_parent")
    return build.function(
        "fused_adam_parent", "p1t_fused_adam",
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_longlong] +
        [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])


def make(shapes, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    ps = [torch.randn(s, device="cuda", generator=g).to(dtype)
          for s in shapes]
    gs = [torch.randn(s, device="cuda", generator=g).to(dtype)
          for s in shapes]
    m1 = [torch.randn(s, device="cuda", generator=g) * 0.01 for s in shapes]
    m2 = [torch.rand(s, device="cuda", generator=g) * 0.01 for s in shapes]
    return ps, gs, m1, m2


def scalars():
    return torch.tensor([1e-4, 1 - BETA1 ** 3, 1 - BETA2 ** 3],
                        device="cuda")


def check(ps, gs, m1, m2, sc) -> float:
    """This tree's kernel on copies against the plain version; the max
    abs error (raises outside rtol 1e-6 / atol 1e-7)."""
    cp = [[t.clone() for t in ts] for ts in (ps, m1, m2)]
    want = [fa.fused_adam_ref(p, q, a, b, sc[0], sc[1], sc[2], DECAY, BETA1,
                              BETA2, EPS) for p, q, a, b in zip(ps, gs, m1,
                                                                 m2)]
    fa.fused_adam_(cp[0], gs, cp[1], cp[2], sc, [DECAY] * len(ps), BETA1,
                   BETA2, EPS)
    torch.cuda.synchronize()
    err = 0.0
    for got, w in zip(zip(*cp), want):
        for a, b in zip(got, w):
            a, b = a.float(), b.float()
            err = max(err, float((a - b).abs().max()))
            if not bool(torch.isclose(a, b, rtol=cs.ADAM_RTOL,
                                      atol=cs.ADAM_ATOL).all()):
                raise SystemExit(f"fused_adam_ outside rtol {cs.ADAM_RTOL} "
                                 f"atol {cs.ADAM_ATOL}: {err}")
    return err


def calls(ps, gs, m1, m2, sc, parent):
    """The three updates over the same tensors, by name."""
    n = len(ps)
    out = {"kernel": lambda: fa.fused_adam_(ps, gs, m1, m2, sc, [DECAY] * n,
                                            BETA1, BETA2, EPS)}
    lib = [torch.nn.Parameter(p) for p in ps]     # p's storage
    for p, q in zip(lib, gs):
        p.grad = q
    opt = torch.optim.AdamW(lib, lr=1e-4, weight_decay=DECAY, fused=True,
                            capturable=True)
    out["library"] = opt.step
    if parent is not None:
        rows, first = [], 0
        for p, q, a, b in zip(ps, gs, m1, m2):
            k = p.nelement()
            rows.append([p.data_ptr(), q.data_ptr(), a.data_ptr(),
                         b.data_ptr(), k, first])
            first += -(-k // 16384)
        table = torch.tensor(rows, dtype=torch.int64, device="cuda")
        coef = torch.tensor([[DECAY, 1.0]] * n, dtype=torch.float32,
                            device="cuda")
        kind = 0 if ps[0].dtype == torch.float32 else 1

        def old():
            rc = parent(table.data_ptr(), coef.data_ptr(), sc.data_ptr(), n,
                        first, 16384, BETA1, BETA2, 1 - BETA1, 1 - BETA2,
                        EPS, kind, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"parent kernel: CUDA error {rc}")
        out["parent"] = old
    return out


def bound_ms(n_el: int, item: int) -> float:
    return 1e3 * (3 * item + 16) * n_el / cs.HBM_BYTES_PER_S


def registers() -> dict:
    log = build.build_log("fused_adam") or ""
    return {m.group(1)[-60:]: int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?Used (\d+) registers", log,
        re.S)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", nargs="+", choices=tuple(SHAPES),
                    default=list(SHAPES))
    ap.add_argument("--dtypes", nargs="+", choices=tuple(DTYPES),
                    default=list(DTYPES))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", default="HEAD")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_adam_bench: no CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    parent = None if args.sweep else parent_kernel(args.parent)
    for size, dname in itertools.product(args.sizes, args.dtypes):
        shapes = SHAPES[size]()
        n_el = sum(int(np.prod(s)) for s in shapes)
        ps, gs, m1, m2 = make(shapes, DTYPES[dname], cs.SEED + 17)
        sc = scalars()
        head = {"card": card, "size": size, "dtype": dname,
                "tensors": len(shapes), "elements": n_el,
                "bound_ms": bound_ms(n_el, ps[0].element_size())}
        if args.sweep:
            for chunk, ctas in itertools.product(*SWEEP.values()):
                fa.CHUNK, fa.CTAS_PER_SM = chunk, ctas
                err = check(ps, gs, m1, m2, sc) if size == "bert" else None
                fn = calls(ps, gs, m1, m2, sc, None)["kernel"]
                times = [cs.graph_time_ms([fn], args.reps)
                         for _ in range(args.rounds)]
                print(json.dumps({**head, "chunk": chunk,
                                  "ctas_per_sm": ctas,
                                  "max_abs_err": err,
                                  "median_ms": statistics.median(times),
                                  "spread_ms": max(times) - min(times)}),
                      flush=True)
            continue
        err = check(ps, gs, m1, m2, sc)
        fns = calls(ps, gs, m1, m2, sc, parent)
        times = {k: [] for k in fns}
        order = list(fns)
        for r in range(args.rounds):
            for k in (order if r % 2 == 0 else order[::-1]):
                times[k].append(cs.graph_time_ms([fns[k]], args.reps))
        print(json.dumps({
            **head, "max_abs_err": err,
            "settings": {"chunk": fa.CHUNK, "ctas_per_sm": fa.CTAS_PER_SM},
            "library_bytes_per_element": 7 * ps[0].element_size(),
            "rounds_ms": times,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "spread_ms": {k: max(v) - min(v) for k, v in times.items()}}),
            flush=True)
        del fns, ps, gs, m1, m2
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "registers": registers()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
