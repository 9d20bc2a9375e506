#!/usr/bin/env python3
"""The host cost of the Paddle facade's shared-name methods, per call and
per eager step.

A facade method whose name is also a ``torch.Tensor`` method runs a
Python dispatcher (``paddle1_tpu_torch/ops/patch.py``, the collision
rule) before its op. This

* counts, with ``sys.setprofile``, the calls of those methods (on facade
  tensors and on the layers' parameters, which carry the same methods)
  in one eager step of ``chip_smoke.py`` phase 21's fine-tuning loop
  (``BertForSequenceClassification`` at BERT-base depth, 12 layers, and
  AdamW; the count does not depend on width, so the model is narrow:
  hidden 128, 2 heads of 64, FFN 256, batch 2 x 16) and of phase 15's
  LeNet loop (batch 8), on ``--device`` (default: the card when there is
  one, where the steps run the port's kernels; else the CPU, where they
  run the plain versions);
* times, per call on CPU tensors, the calls the BERT step made before its
  modules called torch's functions instead (``transpose``, ``mean``,
  ``masked_fill``, ``reshape``, ``unsqueeze``) on a ``[4, 8]`` tensor,
  against torch's method called directly on the same tensor
  (``torch.Tensor.<name>(x, ...)``, no dispatcher), in turns, each the
  median of ``--rounds`` windows of ``--reps`` calls;
* times ``__getitem__`` the same way, on a facade tensor (``x[1:3]``) and
  on a layer's parameter (``param[0]``), against
  ``torch.Tensor.__getitem__``: the cost of the Python indexing that
  turns negative-step slices into a flip;
* prints one JSON object: ``calls_per_step`` by model and name,
  ``us_per_call`` by timed call (``facade``, ``torch``, ``dispatcher`` =
  their difference), ``dispatcher_ms_per_step``: each model's calls
  times the timed calls' median dispatcher µs, and the same for
  indexing (``index_us_per_call``, ``index_ms_per_step``: each model's
  ``__getitem__`` calls times the indexing's median).

    python3 tools/torch_method_cost.py [--reps 20000] [--rounds 5]
        [--device cpu|cuda] [--root DIR]

``--root DIR`` imports the package from another tree.

The times are the host's that runs it; the step they add to is the host
time of an eager step on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
paddle = None     # the package, imported in main() (``--root``)


def _method_codes() -> set:
    """The code objects of the facade's and the layers' parameters'
    (``ParamBase``) methods that share their name with a ``torch.Tensor``
    method (the patch builds many from one closure)."""
    from paddle1_tpu_torch.core.tensor import ParamBase
    codes = set()
    for cls in (paddle.Tensor, ParamBase):
        for name, attr in vars(cls).items():
            if not hasattr(torch.Tensor, name):
                continue
            fn = attr.fget if isinstance(attr, property) else attr
            code = getattr(fn, "__code__", None)
            if code is not None and code.co_filename.endswith(
                    os.path.join("ops", "patch.py")):
                codes.add(code)
    return codes


def _method_name(frame) -> str:
    """The name of the facade method running in ``frame``: its closure's
    torch method or property, else its own."""
    local = frame.f_locals
    for k in ("torch_fn", "torch_prop"):
        if k in local:
            return local[k].__name__
    return frame.f_code.co_name


def count_calls(step) -> Counter:
    codes = _method_codes()
    calls = Counter()

    def prof(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            calls[_method_name(frame)] += 1
    sys.setprofile(prof)
    try:
        float(step())
    finally:
        sys.setprofile(None)
    return calls


def bert_step(dev):
    from paddle1_tpu_torch.text.models import (
        BertForSequenceClassification, BertModel)
    F = paddle.nn.functional
    gen = torch.Generator().manual_seed(0)
    with paddle.utils.unique_name.guard():
        clf = BertForSequenceClassification(
            BertModel(vocab_size=1000, hidden_size=128,
                      num_hidden_layers=12, num_attention_heads=2,
                      intermediate_size=256, device=dev, generator=gen),
            num_classes=2)
    decay = [p.name for n, p in clf.named_parameters()
             if not any(nd in n for nd in ["bias", "norm"])]
    opt = paddle.optimizer.AdamW(
        learning_rate=2e-5, parameters=clf.parameters(), weight_decay=0.01,
        apply_decay_param_fun=lambda x: x in decay)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1000, (2, 16))
    ids[1, 10:] = 0                       # ragged: a padded row
    x = paddle.to_tensor(ids.astype(np.int64))
    y = paddle.to_tensor(np.array([0, 1], np.int64))

    def step():
        loss = F.cross_entropy(clf(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def lenet_step():
    from paddle1_tpu_torch.vision.models import LeNet
    F = paddle.nn.functional
    paddle.seed(0)
    model = LeNet()
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())
    rng = np.random.default_rng(0)
    x = paddle.to_tensor(rng.standard_normal((8, 1, 28, 28)).astype(
        np.float32))
    y = paddle.to_tensor(rng.integers(0, 10, (8,)).astype(np.int64))

    def step():
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def _window_us(fn, reps) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e6 / reps


def time_calls(reps, rounds):
    """µs per call, facade method against torch's, as the BERT step
    calls them (torch's arguments reach torch's method through the
    dispatcher; Paddle's reach Paddle's op); then the same for indexing.
    Returns the two dicts."""
    x = paddle.to_tensor(np.ones((4, 8), np.float32))
    m = paddle.to_tensor(np.zeros((4, 8), bool))
    T = torch.Tensor
    calls = {
        "transpose(0, 1)": (lambda: x.transpose(0, 1),
                            lambda: T.transpose(x, 0, 1)),
        "mean(-1, keepdim=True)": (lambda: x.mean(-1, keepdim=True),
                                   lambda: T.mean(x, -1, keepdim=True)),
        "masked_fill(mask, 0.0)": (lambda: x.masked_fill(m, 0.0),
                                   lambda: T.masked_fill(x, m, 0.0)),
        "reshape([8, 4])": (lambda: x.reshape([8, 4]),
                            lambda: T.reshape(x, [8, 4])),
        "unsqueeze(1)": (lambda: x.unsqueeze(1), lambda: T.unsqueeze(x, 1)),
    }
    # indexing: the facade's and the parameters' ``__getitem__`` (which
    # turns negative-step slices into a flip) against torch's own
    w = paddle.nn.Linear(8, 4).weight
    index = {
        "x[1:3]": (lambda: x[1:3], lambda: T.__getitem__(x, slice(1, 3))),
        "param[0]": (lambda: w[0], lambda: T.__getitem__(w, 0)),
    }
    return _time_pairs(calls, reps, rounds), _time_pairs(index, reps, rounds)


def _time_pairs(calls, reps, rounds) -> dict:
    out = {}
    for name, (facade, plain) in calls.items():
        f, p = [], []
        for _ in range(rounds):
            for fn, acc in ((facade, f), (plain, p), (plain, p),
                            (facade, f)):
                acc.append(_window_us(fn, reps))
        fu, pu = float(np.median(f)), float(np.median(p))
        out[name] = {"facade": fu, "torch": pu, "dispatcher": fu - pu}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=(
        "cuda" if torch.cuda.is_available() else "cpu"))
    ap.add_argument("--root", default=ROOT,
                    help="import paddle1_tpu_torch from this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    global paddle
    import paddle1_tpu_torch as paddle
    torch.set_num_threads(1)
    with paddle.device_guard(args.device):
        steps = {"bert_finetune": bert_step(args.device),
                 "lenet": lenet_step()}
        counts = {}
        for model, step in steps.items():
            float(step())                  # warm: the optimizer's state
            counts[model] = count_calls(step)
    with paddle.device_guard("cpu"):
            us, index_us = time_calls(args.reps, args.rounds)
    per_call = float(np.median([v["dispatcher"] for v in us.values()]))
    per_index = float(np.median([v["dispatcher"] for v in
                                 index_us.values()]))
    print(json.dumps({
        "count_device": args.device,
        "calls_per_step": {k: dict(v.most_common())
                           for k, v in counts.items()},
        "calls_per_step_total": {k: sum(v.values())
                                 for k, v in counts.items()},
        "us_per_call": us,
        "dispatcher_us_median": per_call,
        "dispatcher_ms_per_step": {k: sum(v.values()) * per_call / 1e3
                                   for k, v in counts.items()},
        "index_us_per_call": index_us,
        "index_ms_per_step": {k: v["__getitem__"] * per_index / 1e3
                              for k, v in counts.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
