#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 43-45 alone: the collectives on NCCL
and the all-reduce bus-bandwidth sweep (``collectives_phase``), BASELINE
config 4 through ``fleet`` at full width and depth (``ernie_fleet_phase``)
and the cross-rank check of the ZeRO and tensor-parallel engine at
ERNIE-1.5B's width (``hybrid_rank_check``), with the checks of the whole
smoke.

Run from the repo root::

    python3 tools/torch_hybrid_phases.py [--out FILE] [--phases 43 44 45]
        [--gloo-probe] [--plant zero_shard unaveraged drop_f]

Builds every kernel (``ops/cuda/build.py``), turns TF32 off in matmuls
and cuDNN as ``chip_smoke.main`` does, runs the chosen phases in the
smoke's order and prints each one's result as a JSON line, then the
card's name and power limit. ``--gloo-probe`` first asks gloo, on two
ranks sharing the card, which collectives it runs on CUDA tensors (the
port stages none through host memory, so a refused one fails phase 45).
``--plant`` runs phase 45 again with each named fault planted in its mesh
(``chip_smoke.HY_PLANTS``, ``hy_plant``) and fails unless the check
catches every one: the readings that place its limits.
``--out`` also writes all of it as one JSON object. Exits 1 when a check
fails and 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
             "all_gather_into", "all_to_all", "scatter")
# point-to-point and the one-step shift (an all-to-all whose splits move
# each rank's tensor to the next rank only): each in a pair of ranks of
# its own, since a transport handed a device pointer may end its process
P2P_OPS = ("send_recv", "isend_irecv", "batch_isend_irecv",
           "all_to_all_shift")


def _probe_one(op, rank, dev):
    """One torch.distributed call of ``op`` on CUDA tensors, unstaged."""
    import torch.distributed as dist
    x = torch.arange(4, dtype=torch.float32, device=dev) + rank
    if op == "all_reduce":
        dist.all_reduce(x)
    elif op == "broadcast":
        dist.broadcast(x, 0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif op == "reduce_scatter":
        dist.reduce_scatter_tensor(torch.empty(2, device=dev), x)
    elif op == "all_gather_into":
        dist.all_gather_into_tensor(torch.empty(8, device=dev), x)
    elif op == "all_to_all":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif op == "scatter":
        dist.scatter(torch.empty_like(x),
                     [x.clone(), x.clone()] if rank == 0 else None, src=0)
    torch.cuda.synchronize(dev)


def _probe_p2p(op, rank, dev):
    """One point-to-point transfer (or the shift) of ``op`` between two
    ranks on CUDA tensors, unstaged; returns whether rank 1 (rank 0 for
    the shift too) received the peer's values."""
    import torch.distributed as dist
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    got = torch.zeros(4, device=dev)
    peer = 1 - rank
    if op == "send_recv":
        # one point-to-point pair: rank 0's send is rank 1's recv
        if rank == 0:
            dist.send(x, 1)  # noqa: rank-divergent-collective — the pair's send
        else:
            dist.recv(got, 0)  # noqa: rank-divergent-collective — its recv
    elif op == "isend_irecv":
        w = dist.isend(x, 1) if rank == 0 else dist.irecv(got, 0)
        w.wait()
    elif op == "batch_isend_irecv":
        ops = [dist.P2POp(dist.isend, x, peer),
               dist.P2POp(dist.irecv, got, peer)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    elif op == "all_to_all_shift":
        # rank j's tensor to rank j + 1 (two ranks: a swap), the splits
        # sending nothing to any other rank
        splits = [0, 4] if rank == 0 else [4, 0]
        dist.all_to_all_single(got, x, splits, splits)
    torch.cuda.synchronize(dev)
    want = torch.arange(4, dtype=torch.float32) + 10 * peer
    one_way = op in ("send_recv", "isend_irecv")
    return (one_way and rank == 0) or bool(torch.equal(got.cpu(), want))


def p2p_worker(out_dir, init_file, op):
    """A rank of one point-to-point probe."""
    from paddle1_tpu_torch import distributed as pdist
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    dev = torch.device("cuda", 0)
    pdist.init_parallel_env(backend="gloo", device=dev,
                            init_method=f"file://{init_file}")
    try:
        try:
            res = ("runs on CUDA tensors" if _probe_p2p(op, rank, dev)
                   else "runs, wrong values")
        except Exception as e:   # noqa: BLE001 (the answer sought)
            res = f"{type(e).__name__}: {str(e).strip()[:160]}"
        with open(os.path.join(out_dir, f"p2p{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        pdist.destroy_process_group()


def p2p_probe():
    """Each of P2P_OPS in a gloo pair of its own on the card."""
    from paddle1_tpu_torch import distributed as pdist
    res = {}
    for op in P2P_OPS:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                pdist.spawn(p2p_worker, args=(tmp, os.path.join(
                    tmp, "store"), op), nprocs=2, timeout=120)
                got = []
                for r in range(2):
                    with open(os.path.join(tmp, f"p2p{r}.json")) as f:
                        got.append(json.load(f))
                res[op] = got[1] if got[0] == "runs on CUDA tensors" \
                    else got[0]
            except Exception as e:   # noqa: BLE001 (a rank died)
                res[op] = f"a rank failed: {type(e).__name__}: " \
                    f"{str(e).strip()[:160]}"
    cs.log(json.dumps({"gloo_cuda_p2p_probe": res}))
    return res


def probe_worker(out_dir, init_file):
    """A rank of the gloo probe: every op, in turn, on both ranks; a
    refused op raises on both before any traffic."""
    from paddle1_tpu_torch import distributed as pdist
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    dev = torch.device("cuda", 0)
    pdist.init_parallel_env(backend="gloo", device=dev,
                            init_method=f"file://{init_file}")
    res = {}
    try:
        for op in PROBE_OPS:
            try:
                _probe_one(op, rank, dev)
                res[op] = "runs on CUDA tensors"
            except Exception as e:   # noqa: BLE001 (the answer sought)
                res[op] = f"{type(e).__name__}: {str(e).strip()[:160]}"
            torch.distributed.barrier()
        with open(os.path.join(out_dir, f"probe{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        pdist.destroy_process_group()


def gloo_probe():
    from paddle1_tpu_torch import distributed as pdist
    with tempfile.TemporaryDirectory() as tmp:
        pdist.spawn(probe_worker, args=(tmp, os.path.join(tmp, "store")),
                    nprocs=2, timeout=120)
        with open(os.path.join(tmp, "probe0.json")) as f:
            res = json.load(f)
    cs.log(json.dumps({"gloo_cuda_probe": res}))
    res.update(p2p_probe())
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this file")
    ap.add_argument("--phases", nargs="*", type=int, default=[43, 44, 45],
                    choices=[43, 44, 45])
    ap.add_argument("--gloo-probe", action="store_true")
    ap.add_argument("--plant", nargs="+", default=[],
                    choices=sorted(cs.HY_PLANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_hybrid_phases: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    t0 = time.perf_counter()
    build.build_all()
    out = {"card": card, "seconds": {"build": time.perf_counter() - t0}}
    if args.gloo_probe:
        out["gloo_cuda_probe"] = gloo_probe()
    for phase, key, run in ((43, "collectives_nccl", cs.collectives_phase),
                            (44, "ernie_fleet", cs.ernie_fleet_phase),
                            (45, "hybrid_rank_check",
                             lambda d: cs.hybrid_rank_check(d, args.plant))):
        if phase not in args.phases:
            continue
        t0 = time.perf_counter()
        out[key] = run(dev)
        out["seconds"][key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    cs.log(json.dumps({"seconds": out["seconds"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"torch_hybrid_phases: {e}", file=sys.stderr)
        sys.exit(1)
