#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 32-33 alone on one CUDA card: row 7 held
and timed at the attention LSTM seq2seq's shapes (``ls_softmax_hold``),
its eager f32 training (``lstm_seq2seq_phase``), beam search
(``lstm_decode_phase``), ``nn.LSTM`` against ``nn.RNN(nn.LSTMCell)``
(``lstm_cell_equivalence``) and the kernel path against the plain path
(``lstm_reference_check``), with the checks of the whole smoke.

Run from the repo root::

    python3 tools/torch_seq2seq_phases.py [--out FILE]

Builds every kernel (``ops/cuda/build.py``), turns TF32 off in matmuls
and cuDNN as ``chip_smoke.main`` does, runs the phases in the smoke's
order and prints each one's result as a JSON line, then the card's name
and power limit. ``--out`` also writes all of it as one JSON object.
Exits 1 when a check fails and 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_seq2seq_phases: no CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(card)
    build.build_all()
    out = {"card": card, "softmax": cs.ls_softmax_hold(dev)}
    model, out["train"] = cs.lstm_seq2seq_phase(dev)
    out["decode"] = cs.lstm_decode_phase(dev, model)
    del model
    torch.cuda.empty_cache()
    out["lstm_cell_equivalence"] = cs.lstm_cell_equivalence(dev)
    out["reference"] = cs.lstm_reference_check(dev)
    for key in ("softmax", "train"):
        cs.log(json.dumps({key: out[key]}, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"torch_seq2seq_phases: {e}", file=sys.stderr)
        sys.exit(1)
