#!/usr/bin/env python3
"""Host-bound steps of two trees of the PyTorch port, in turns, on one card.

The serving decode step (``tools/torch_decode_profile.py``: the README
width, 16 active slots) and the bf16 ResNet-50 training step
(``tools/torch_train_profile.py --model resnet50``: batch 32 x 224²) are
host-bound: the device idles most of each step. A change to the layers
under them shows there first. So do the eager steps on the Paddle
facade (``--model lenet``, batch 64; ``--model bert_finetune``, BERT-base
f32 at batch 32 x 128), whose host cost the facade's methods add to.
This runs each tool in the order A, B, B, A, and prints one JSON object
with every run's step time and idle share and the per-tree medians. The
first two run from each tree's own copy (so each imports its own
``paddle1_tpu_torch`` and builds its own kernels); the eager steps run
this tree's ``tools/torch_train_profile.py`` with ``--root`` set to each
tree, so both trees run one tool.

    python3 tools/torch_host_ab.py --a DIR_A [--b DIR_B] [--rounds 1]

``--b`` defaults to this tree. Each run is a process of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {
    "decode": (["tools/torch_decode_profile.py", "--steps", "60",
                "--profile-steps", "10"],
               ("decode_step_ms_p50", "decode_step_ms_mean",
                "device_idle_share")),
    "resnet50": (["tools/torch_train_profile.py", "--model", "resnet50",
                  "--steps", "20", "--profile-steps", "3"],
                 ("step_ms", "device_idle_share_untraced",
                  "kernel_launches_per_step")),
    "lenet": (["tools/torch_train_profile.py", "--model", "lenet",
               "--steps", "75", "--profile-steps", "5"],
              ("step_ms", "device_idle_share_untraced",
               "facade_calls_per_step")),
    "bert_finetune": (["tools/torch_train_profile.py", "--model",
                       "bert_finetune", "--steps", "20", "--profile-steps",
                       "3"],
                      ("step_ms", "device_idle_share_untraced",
                       "facade_calls_per_step")),
}
# tools run from this tree against each tree's package (``--root``)
SHARED = ("lenet", "bert_finetune")


def run(tree: str, tool: str) -> dict:
    args, keys = TOOLS[tool]
    if tool in SHARED:
        args = [os.path.join(ROOT, args[0])] + args[1:] + ["--root", tree]
    proc = subprocess.run([sys.executable] + args, cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} in {tree} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"card": out.get("card"), **{k: out.get(k) for k in keys}}


def median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="tree A (say the parent)")
    ap.add_argument("--b", default=ROOT, help="tree B (default: this one)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="A, B, B, A sequences per tool")
    ap.add_argument("--tools", nargs="+", default=list(TOOLS),
                    choices=list(TOOLS), help="which steps (default: all)")
    args = ap.parse_args()
    trees = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    result = {"card": card.splitlines()[0] if card else None,
              "trees": trees, "runs": {}, "median": {}}
    for tool in args.tools:
        keys = TOOLS[tool][1]
        runs = []
        for _ in range(args.rounds):
            for which in ("a", "b", "b", "a"):
                r = run(trees[which], tool)
                r["tree"] = which
                runs.append(r)
                print(json.dumps({tool: r}), file=sys.stderr, flush=True)
        result["runs"][tool] = runs
        result["median"][tool] = {
            which: {k: median([r[k] for r in runs if r["tree"] == which])
                    for k in keys} for which in ("a", "b")}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
