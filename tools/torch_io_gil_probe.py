#!/usr/bin/env python3
"""Where the DataLoader-fed eager LeNet step's time goes on one CUDA card.

``chip_smoke.py`` phase 35 feeds phase 15's eager LeNet step from
``io.DataLoader`` over MNIST's IDX files. This probe times the same loop,
each step end to end with the loss read back (``chip_smoke.io_step_times``),
in four feeds: batches staged on the card beforehand (no loader), the
single-process iterator (its producer thread stages each batch through
pinned memory on the copy stream), the same iterator started on the CPU
place with each batch moved to the card in the step (``Tensor.to``, no
pinning, no copy stream), and one worker process (the parent's threads
only move batches) — each under the interpreter's default GIL switch
interval (5 ms) and under 0.5 ms, in alternating rounds. A feed whose fed
step falls with the interval is held back by threads of the training
process waiting for the GIL; the host-place feed against the thread's
says what the staging costs the step.

Run from the repo root::

    python3 tools/torch_io_gil_probe.py [--out FILE] [--steps N]

Prints one JSON object (the card's name and power limit in it); exits 2
without a card.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

INTERVALS = (0.005, 0.0005)
FEEDS = ("staged", "thread", "thread_host", "one_worker")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result to this file")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_io_gil_probe: no CUDA card", file=sys.stderr)
        return 2
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.ops.cuda import build
    from paddle1_tpu_torch.vision.models import LeNet
    build.build_all()
    F = paddle.nn.functional
    with tempfile.TemporaryDirectory() as root:
        img_p, lab_p, _, _ = cs.write_mnist(
            root, cs.MNIST_BATCH * (args.steps + 8), "train", cs.SEED + 211)
        train = paddle.vision.datasets.MNIST(
            img_p, lab_p, mode="train", transform=paddle.vision.transforms.
            Normalize(mean=[127.5], std=[127.5], data_format="CHW"))
    paddle.seed(cs.SEED)
    model = LeNet()
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())

    dev = torch.device("cuda", 0)

    def loop(batches, to_card=False):
        def step():
            try:
                t0 = time.perf_counter()
                x, y = next(batches)
                wait = time.perf_counter() - t0
            except StopIteration:
                return None
            if to_card:
                x, y = torch.Tensor.to(x, dev), torch.Tensor.to(y, dev)
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return wait, loss
        return step

    staged = [tuple(t.clone() for t in b) for b, _ in zip(
        paddle.io.DataLoader(train, batch_size=cs.MNIST_BATCH), range(2))]

    def run(feed):
        if feed == "staged":
            it = (staged[k % 2] for k in range(args.steps))
            steps, waits, _ = cs.io_step_times(loop(it), args.steps)
        else:
            loader = paddle.io.DataLoader(
                train, batch_size=cs.MNIST_BATCH, shuffle=True,
                num_workers=1 if feed == "one_worker" else 0)
            with paddle.device_guard("cpu" if feed == "thread_host" else
                                     "gpu:0"):
                it = iter(loader)
            try:
                steps, waits, _ = cs.io_step_times(
                    loop(it, feed == "thread_host"), args.steps)
            finally:
                it.shutdown()
        return (float(np.median(steps[cs.IO_WARMUP:])),
                float(np.median(waits[cs.IO_WARMUP:])))

    default = sys.getswitchinterval()
    out = {f"{feed}@{iv}": [] for iv in INTERVALS for feed in FEEDS}
    for r in range(args.rounds):
        for iv in (INTERVALS if r % 2 == 0 else INTERVALS[::-1]):
            sys.setswitchinterval(iv)
            try:
                for feed in FEEDS:
                    out[f"{feed}@{iv}"].append(run(feed))
            finally:
                sys.setswitchinterval(default)
    result = {"card": cs.card_line(), "steps": args.steps,
              "batch": cs.MNIST_BATCH,
              "timing": "host clock per step, next() included, loss read "
                        "back; median over the steps after 2",
              "runs": {k: [{"step_ms": s, "loader_wait_ms": w}
                           for s, w in v] for k, v in out.items()}}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
