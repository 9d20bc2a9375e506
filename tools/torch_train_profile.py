#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one card.

``--model bert`` (the default) builds the BERT training path of
``chip_smoke.py`` (``ParallelEngine`` over
``BertForPretraining(bert_base())`` + AdamW, bf16 with f32 masters, batch
``--batch`` x seq ``--seq``, seeded random weights, ``bench.py``'s batch);
``--model resnet50`` its ResNet-50 path (``resnet50()`` + Momentum(1e-3,
0.9), bf16, batch ``--batch`` (default 32) x 3 x 224 x 224 from
``benches.py:91-162``, two seeded batches staged on the card and cycled);
``--model resnet50 --dp`` the same on its data-parallel path at world size
1 (``init_parallel_env()``: NCCL; ``ParallelEngine`` on
``build_mesh(dp=1)``, so every batch norm runs the local-moments kernel,
an all-reduce each way and the given-statistics kernels);
``--model ernie`` BASELINE config 4 (``benches.py:195-223``):
``ErnieForPretraining(ernie_1p5b())`` at full width and depth (1.64 B
parameters) + AdamW(1e-4), bf16, batch ``--batch`` (default 4) x seq
``--seq`` (default 512), through ``ParallelEngine`` on
``build_mesh(dp=1, sharding=1)`` with ``zero_stage=2``, the batch staged
on the card once; and it also sums the device time of the parameters'
casts and the gradients' copies (copy kernels);
``--model lenet`` the eager LeNet path (BASELINE config 1,
``benches.py:52-88``: ``LeNet()`` + ``Adam(1e-3)``, f32, batch ``--batch``
(default 64) x 1 x 28 x 28, two seeded batches staged with ``to_tensor``
as Paddle tensors, forward, cross entropy, ``backward()``, ``step()``,
``clear_grad()``; the smoke's ``lenet_batches`` and ``lenet_step_fn``),
and also counts the calls that go through the Paddle
facade's ``Tensor.__torch_function__`` (each re-wraps its results) in
one step. The facade's host cost in time is ``chip_smoke.py`` phase 15's
(the same loop on plain torch parameters and inputs, in turns);
``--model bert_finetune`` ``chip_smoke.py`` phase 21's eager BERT-base
fine-tuning step, built by the smoke's own helpers (``ft_setup``,
``ft_step_fn``: ``BertForSequenceClassification`` at full width and
depth warm-started from a seeded pretraining model, f32 with TF32 off,
AdamW with the warm-up schedule, batch ``--batch`` (default 32) x seq
128 with ragged padding, two seeded batches staged as Paddle tensors;
``loss.backward(); opt.step(); sched.step(); opt.clear_grad()``), also
counting the facade's calls. ``--root DIR`` imports the package from
another tree (say the parent, unpacked under ``_archive/``), so two trees
run the same tool.
It runs ``--warmup`` steps, then:

* times ``--steps`` steps on the host clock, ending in one loss readback
  (step ms = the window over the steps);
* profiles ``--profile-steps`` more with ``torch.profiler`` (CPU + CUDA
  activities) and reports the device's busy time per step (sum of kernel
  times), its idle share, the time per step of the port's own kernels
  (for ResNet-50, the fused batch-norm family and its share of the busy
  time), of the library's matrix products and convolutions and of
  everything else, and the kernels by total device time; with ``--dp``
  also the device time per step of the all-reduces (NCCL) and of the
  local moments' backward (plain PyTorch), which this tool labels. The
  port's kernels are split by kernel, each with its device ms and its
  launches per step (for ResNet-50, the batch-norm family's kernels).

Prints one JSON object.

    python3 tools/torch_train_profile.py [--model resnet50 [--dp] | lenet |
        ernie | bert_finetune] [--steps 10] [--root DIR]
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

OUR_KERNELS = {
    # bf16: the three flash passes on the tensor cores
    "bert": ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
             "flash_bwd_dq_tc_kernel", "adam_kernel",
             "layer_norm_warp_kernel"),
    # ops/cuda/fused_bn.cu, fused_bn_bwd.cu: the training forward and the
    # training backward, one launch each; the given-statistics forward
    # (normalize) and backward; the local moments (dp); and, for a tree
    # before the one-launch moments and given-statistics backward, the
    # partial-sum pass and the finalize
    "resnet50": ("train_fwd_kernel", "moments_kernel",
                 "stats_partial_kernel", "finalize_kernel",
                 "normalize_kernel", "train_bwd_kernel", "norm_bwd_kernel"),
    "lenet": ("adam_kernel",),
    # f32: the CUDA-core flash kernels and the block LayerNorm
    "bert_finetune": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                      "adam_kernel", "layer_norm"),
    # ERNIE's hidden 2304 is past the warp-per-row widths
    "ernie": ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
              "flash_bwd_dq_tc_kernel", "adam_kernel",
              "layer_norm_block_kernel"),
}


HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (published peak)


def resnet50_bn_shapes(batch: int, img: int = 224):
    """``(rows, C)`` of ResNet-50's 53 batch norms, in order, at ``batch``
    images of ``img`` x ``img``: the stem at img / 2, then stages of 3, 4,
    6 and 3 bottlenecks of widths 64-512 (x 4 out), the stride on each
    later stage's first 3 x 3 convolution, a projection on each stage's
    first block."""
    side = img // 4                       # after the stem and the pool
    out = [(batch * (img // 2) ** 2, 64)]
    for stage, (blocks, width) in enumerate(((3, 64), (4, 128), (6, 256),
                                             (3, 512))):
        for blk in range(blocks):
            first = (batch * side ** 2, width)
            if stage and blk == 0:
                side //= 2
            rows = batch * side ** 2
            out += [first, (rows, width), (rows, 4 * width)]
            if blk == 0:
                out.append((rows, 4 * width))     # the projection's
    return out


def bn_bound_ms_per_step(batch: int, itemsize: int = 2):
    """The least device time a step's batch norms could take on an H100
    SXM, per kernel of the family, summed over :func:`resnet50_bn_shapes`:
    each kernel's inputs read once and outputs written once (x and y for
    the forwards, x, dy and dx for the backwards, x alone for the
    moments; the per-channel vectors are negligible) over 3.35 TB/s."""
    n = sum(rows * c for rows, c in resnet50_bn_shapes(batch)) * itemsize
    return {kind: 1e3 * k * n / HBM_BYTES_PER_S for kind, k in (
        ("train_fwd", 2), ("norm_fwd", 2), ("train_bwd", 3),
        ("norm_bwd", 3), ("moments", 1))}


def _is_gemm(name: str) -> bool:
    """cuBLAS/CUTLASS matrix-product and cuDNN convolution kernels
    (``nvjet`` is cuBLAS's Hopper family; cuDNN's convolutions run as
    implicit GEMMs: ``xmma``/``cutlass`` kernels named for their
    ``fprop``/``dgrad``/``wgrad`` pass)."""
    low = name.lower()
    return any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass",
                                  "fprop", "dgrad", "wgrad"))


def _bert(args, dev):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import (BertForPretraining,
                                               BertPretrainingCriterion,
                                               bert_base)
    gen = torch.Generator().manual_seed(args.seed)
    model = BertForPretraining(bert_base(hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.0,
                                         generator=gen), generator=gen)
    crit = BertPretrainingCriterion(model.bert.vocab_size)

    def loss_fn(m, b):
        scores, rel = m(b["ids"])
        return crit(scores, rel, b["mlm"], b["nsp"])
    eng = ParallelEngine(model, AdamW(learning_rate=1e-4,
                                      parameters=model.parameters()),
                         loss_fn, amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    v = model.bert.vocab_size
    batch = {"ids": rng.integers(1, v, (args.batch, args.seq)).astype(
                 np.int32),
             "mlm": rng.integers(0, v, (args.batch, args.seq)).astype(
                 np.int32),
             "nsp": rng.integers(0, 2, (args.batch,)).astype(np.int32)}
    return lambda: eng.step(batch), {"seq_len": args.seq}


def _ernie(args, dev):
    from paddle1_tpu_torch.distributed import ParallelEngine, build_mesh
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import (BertPretrainingCriterion,
                                               ErnieForPretraining,
                                               ernie_1p5b)
    gen = torch.Generator().manual_seed(args.seed)
    model = ErnieForPretraining(ernie_1p5b(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        generator=gen), generator=gen)
    crit = BertPretrainingCriterion(model.bert.vocab_size)

    def loss_fn(m, b):
        scores, rel = m(b["ids"])
        return crit(scores, rel, b["mlm"], b["nsp"])
    eng = ParallelEngine(model, AdamW(learning_rate=1e-4,
                                      parameters=model.parameters()),
                         loss_fn, mesh=build_mesh(dp=1, sharding=1),
                         zero_stage=2, amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    v = model.bert.vocab_size
    staged = eng.shard_batch({
        "ids": rng.integers(1, v, (args.batch, args.seq)).astype(np.int32),
        "mlm": rng.integers(0, v, (args.batch, args.seq)).astype(np.int32),
        "nsp": rng.integers(0, 2, (args.batch,)).astype(np.int32)})
    n_params = sum(p.numel() for p in model.parameters())
    return lambda: eng.step(staged), {"seq_len": args.seq,
                                      "params": n_params}


def _resnet50(args, dev):
    from paddle1_tpu_torch import distributed as pdist
    from paddle1_tpu_torch.nn import functional as F
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet50
    mesh = None
    if args.dp:
        pdist.init_parallel_env()
        mesh = pdist.build_mesh(dp=1)
    model = resnet50(generator=torch.Generator().manual_seed(args.seed))
    eng = pdist.ParallelEngine(
        model, Momentum(learning_rate=1e-3, momentum=0.9,
                        parameters=model.parameters()),
        lambda m, b: F.cross_entropy(m(b["x"]), b["y"]), mesh=mesh,
        amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    staged = [eng.shard_batch({
        "x": torch.from_numpy(rng.standard_normal(
            (args.batch, 3, 224, 224)).astype(np.float32)).to(dev),
        "y": torch.from_numpy(rng.integers(0, 1000, (args.batch,))).to(dev)})
        for _ in range(2)]
    turn = [0]

    def step():
        turn[0] += 1
        return eng.step(staged[turn[0] % 2])
    return step, {"img": 224, "dp_world_size": 1 if args.dp else None}


def _smoke():
    """This tree's ``chip_smoke.py`` as a module (its helpers build the
    eager steps, so this tool times the smoke's own step), loaded by path:
    ``--root`` may put another tree's first on ``sys.path``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lenet(args, dev):
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.vision.models import LeNet
    smoke = _smoke()
    paddle.seed(smoke.SEED)
    model = LeNet()
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())
    step = smoke.lenet_step_fn(paddle, model, opt, smoke.lenet_batches(
        paddle, batch=args.batch))
    return step, {"img": 28, "amp": None}


def _bert_finetune(args, dev):
    import paddle1_tpu_torch as paddle
    smoke = _smoke()
    clf, opt, sched, batches, _ = smoke.ft_setup(paddle, args.batch)
    step = smoke.ft_step_fn(paddle, clf, opt, sched, batches)
    return step, {"seq": smoke.FT_SEQ, "amp": None}


def _facade_calls(step):
    """Calls through the Paddle ``Tensor.__torch_function__`` in one step
    and its loss readback."""
    from paddle1_tpu_torch.core.tensor import Tensor
    orig = Tensor.__torch_function__.__func__
    calls = [0]

    def counting(cls, func, types, args=(), kwargs=None):
        calls[0] += 1
        return orig(cls, func, types, args, kwargs)
    Tensor.__torch_function__ = classmethod(counting)
    try:
        float(step())
    finally:
        Tensor.__torch_function__ = classmethod(orig)
    return calls[0]


def _label_dp_work():
    """Run the local moments' backward and every all-reduce under profiler
    labels, so the device work each launches can be summed (tool-side
    only: the port calls ``torch.distributed.all_reduce`` through the
    module)."""
    import torch.distributed as tdist
    from torch.profiler import record_function
    from paddle1_tpu_torch.ops import fused_bn as fbn
    orig_bwd, orig_ar = fbn._LocalMoments.backward, tdist.all_reduce

    def backward(ctx, *grads):
        with record_function("local_moments_backward"):
            return orig_bwd(ctx, *grads)

    def all_reduce(*a, **kw):
        with record_function("all_reduce"):
            return orig_ar(*a, **kw)
    fbn._LocalMoments.backward = staticmethod(backward)
    tdist.all_reduce = all_reduce


def _label_ms(prof, name, n):
    """Device ms per step of the kernels launched under label ``name``
    (the host-side label's tree; its device-side span is left out)."""
    from torch.autograd import DeviceType
    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) \
        / 1e3 / n


def _kernel_times(prof):
    """``{kernel name: (total us, calls)}`` over the device-side kernel
    events of a profile (op rows, which also carry their kernels' device
    time, and the device-side spans of labels, which cover kernels, are
    left out so nothing is counted twice)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us, n = out.get(e.name, (0.0, 0))
        out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--model", choices=("bert", "resnet50", "lenet",
                                        "ernie", "bert_finetune"),
                    default="bert")
    ap.add_argument("--root", default=None,
                    help="import paddle1_tpu_torch from this tree")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 128 (bert), 32 (resnet50), 64 (lenet), "
                         "4 (ernie)")
    ap.add_argument("--seq", type=int, default=None,
                    help="default: 128 (bert), 512 (ernie)")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--dp", action="store_true",
                    help="resnet50 on its data-parallel path, world size 1")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if args.dp and args.model != "resnet50":
        ap.error("--dp needs --model resnet50")
    if args.batch is None:
        args.batch = {"bert": 128, "resnet50": 32, "lenet": 64,
                      "ernie": 4, "bert_finetune": 32}[args.model]
    if args.seq is None:
        args.seq = 512 if args.model == "ernie" else 128
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py:
    torch.backends.cudnn.allow_tf32 = False         # f32 stays f32
    dev = torch.device("cuda", torch.cuda.current_device())
    build = {"bert": _bert, "resnet50": _resnet50, "lenet": _lenet,
             "ernie": _ernie, "bert_finetune": _bert_finetune}
    step, shape = build[args.model](args, dev)
    for _ in range(args.warmup):
        float(step())
    calls = _facade_calls(step) if args.model in ("lenet", "bert_finetune") \
        else None

    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    float(loss)
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    from torch.profiler import ProfilerActivity, profile
    if args.dp:
        _label_dp_work()     # for the profiled steps only
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profile_steps):
            loss = step()
        float(loss)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((name, us, n) for name, (us, n)
                      in _kernel_times(prof).items()), key=lambda k: -k[1])
    n = args.profile_steps
    busy_ms = sum(k[1] for k in kernels) / 1e3 / n if kernels else None
    prof_step_ms = prof_wall_ms / n
    ours = {name: sum(k[1] for k in kernels if name in k[0]) / 1e3 / n
            for name in OUR_KERNELS[args.model]}
    ours_calls = {name: sum(k[2] for k in kernels if name in k[0]) / n
                  for name in OUR_KERNELS[args.model]}
    gemm = sum(k[1] for k in kernels if _is_gemm(k[0])) / 1e3 / n
    result = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0],
        "model": args.model, "batch": args.batch, "amp": "bfloat16",
        **shape,
        "step_ms": step_ms, "samples_per_s": args.batch / step_ms * 1e3,
        "loss": float(loss),
        "profiled_step_ms": prof_step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (None if busy_ms is None
                              else 1.0 - busy_ms / prof_step_ms),
        # the profiler slows the host; against the untraced step
        "device_idle_share_untraced": (None if busy_ms is None
                                       else 1.0 - busy_ms / step_ms),
        "kernel_launches_per_step": (sum(k[2] for k in kernels) / n
                                     if kernels else None),
        "gemm_and_conv_ms_per_step": gemm,
        "our_kernels_ms_per_step": ours,
        "our_kernels_calls_per_step": ours_calls,
        "our_kernels_share_of_busy": (None if not busy_ms
                                      else sum(ours.values()) / busy_ms),
        "other_ms_per_step": (None if busy_ms is None
                              else busy_ms - gemm - sum(ours.values())),
        "top_kernels": [{"name": k[0][:120], "ms_per_step": k[1] / 1e3 / n,
                         "calls_per_step": k[2] / n} for k in kernels[:25]],
    }
    if calls is not None:
        result["facade_calls_per_step"] = calls
    if args.model == "ernie":
        result["copy_kernels_ms_per_step"] = sum(
            k[1] for k in kernels if "copy_kernel" in k[0]) / 1e3 / n
        result["copy_kernels_per_step"] = sum(
            k[2] for k in kernels if "copy_kernel" in k[0]) / n
        result["tokens_per_s"] = args.batch * args.seq / step_ms * 1e3
    if args.model == "resnet50":
        result["bn_bound_ms_per_step"] = bn_bound_ms_per_step(args.batch)
    if args.dp:
        from torch.autograd import DeviceType
        result["nccl_kernels_ms_per_step"] = sum(
            k[1] for k in kernels if "nccl" in k[0].lower()) / 1e3 / n
        result["all_reduce_ms_per_step"] = _label_ms(prof, "all_reduce", n)
        result["all_reduces_per_step"] = sum(
            1 for e in prof.events() if e.name == "all_reduce" and
            e.device_type != DeviceType.CUDA) / n
        result["moments_backward_ms_per_step"] = _label_ms(
            prof, "local_moments_backward", n)
        import torch.distributed as tdist
        tdist.destroy_process_group()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
