#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle1_tpu_torch``) on one CUDA card.

Run from the repo root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. **Card and build.** Print the card's name and power limit (nvidia-smi),
   then build every CUDA kernel of the port from
   ``paddle1_tpu_torch/ops/cuda/*.cu`` (one nvcc per source, in parallel);
   print ptxas's registers and spills, and count the tensor-core
   instructions (``HMMA``) in the SASS of the three tensor-core flash
   kernels (``cuobjdump --dump-sass``): none fails the run; print the
   registers and spills of every batch-norm kernel instantiation.
2. **Kernels.** Hold each kernel against its plain PyTorch version on the
   card at the serving path's shapes (paged attention also with f32
   queries over bf16 pools, with one slot at 496 among 15 short ones and
   with every slot long, each repeated bit for bit, and a CUDA graph of
   the decode case replayed twice equal to the eager call; LayerNorm also
   at a width past the warp-per-row path), and time kernel, plain
   version and
   (where one exists) the single PyTorch library call computing the same
   function. Times are device times from CUDA events around a replayed
   CUDA graph of many calls, so host launch overhead is not counted.
3. **Serving (the main path).** ``GenerationServer`` over ``CausalLM`` at
   the README width (vocab 32000, d_model 512, 8 heads, 12 layers,
   max_seq 512, seeded random weights), paged KV (page 16), 16 slots:
   10 staggered greedy and sampled requests, streamed and drained. The
   kernel launch counters are zeroed just before and read just after;
   the drain report must show ``unaccounted == 0`` and
   ``kv_pages_owed == 0``.
4. **Reference checks.** One greedy request is re-run alone through the
   engine (tokens must equal the served ones) and teacher-forced through
   the plain-version forward (no kernels) on the card: per-step logits
   agree to 1e-3 abs. A short dense-cache (``paged=False``) run at depth 2
   checks the other cache discipline.

5. **Training kernels.** The flash-attention forward, its dK/dV and dQ
   passes and the fused AdamW kernel against their plain versions at the
   BERT-base shapes (q/k/v ``[128, 128, 12, 64]``, BERT-base's ~200
   parameter tensors), in f32 and bf16 (flash: causal in both, and both
   at ERNIE-1.5B's ``[4, 512, 18, 128]``, f32 at the fine-tuning path's
   ``[32, 128, 12, 64]``; bf16 passes repeated bit for bit), with one
   fully padded batch row; AdamW also with mixed per-tensor learning-rate
   scales (0 included) and decays, and timed with them, and on views at
   odd element offsets (the kernel's scalar heads and tails); AdamW and
   ``torch.optim.AdamW(fused=True, capturable=True)`` timed the same way,
   five alternating rounds of graph replays, in f32 and bf16; the LayerNorm
   kernel at the training shapes (bf16 ``[16384, 768]``; ERNIE-1.5B's
   ``[2048, 2304]`` in bf16 and f32, past the warp-per-row widths; the
   fine-tuning path's f32 ``[4096, 768]``); flash timed at the three
   models' shapes (f32 with ragged padding at the fine-tuning one); all
   timed beside their plain versions, the
   PyTorch library calls (``F.scaled_dot_product_attention`` forward, its
   backward alone as graph-replayed forward + backward less the forward,
   with the backend it picks named, and forward + backward eagerly;
   the library's AdamW, ``F.layer_norm``) and their bounds.
6. **Training (the second main path).** ``ParallelEngine`` over
   ``BertForPretraining(bert_base())`` + AdamW in bf16 at batch 128,
   seq 128 (``bench.py``'s configuration and batch, seeded weights): a
   warm-up step, then ``bench.py``'s slope+readback timing over 3 x (2 + 8)
   steps on the repeated batch. The counters are zeroed just before and
   read just after: 12 flash forward, 12 dK/dV, 12 dQ and 1 AdamW launch
   per step and 26 LayerNorm launches per forward. The loss must be finite
   and falling. Prints step ms, samples/s and MFU (``bench.py``'s FLOPs
   over the 989 TFLOP/s bf16 peak).
7. **Training reference check.** BERT at full width and depth 2 in f32:
   three steps on the kernel path against three on the plain path (every
   kernel flag ``never``) from identical weights.
8. **Batch-norm kernels.** The fused batch-norm training forward, the
   given-statistics forward and their two backward passes against their
   plain versions at four ResNet-50 shapes (``[401408, 64]``,
   ``[25088, 512]``, ``[6272, 1024]``, ``[1568, 2048]``: the stem and
   layers 2, 3 and 4 at batch 32), in f32 and bf16, over activation
   {identity, relu} x residual {none, given}, each repeated bit for bit,
   the training forward (one cooperative launch) also replayed in a CUDA
   graph equal to the eager call; timed (bf16, identity, the main path's
   case)
   beside their plain versions, ``F.batch_norm`` on a channels-last
   input (its forward, and its backward alone, whichever backend PyTorch
   picks; printed) and their bounds.
9. **ResNet-50 (the third main path).** ``ParallelEngine`` over
   ``resnet50()`` + ``Momentum(1e-3, 0.9)`` in bf16 at batch 32 x 3 x
   224 x 224 (``benches.py:91-162``, seeded weights, two batches staged
   on the card and cycled): two warm-up steps, then slope+readback timing
   (53 ``fused_bn_train`` + 53 ``train_bwd`` launches per step); then an
   eval forward (53 ``fused_bn_norm``) and one frozen-statistics step
   (every BatchNorm2D ``use_global_stats=True``: 53 ``fused_bn_norm`` + 53
   ``norm_bwd``), the counters zeroed just before and read just after
   each. The loss must be finite and falling. Prints step ms, samples/s,
   MFU (``benches.py:153``'s FLOPs) and peak memory.
10. **ResNet-50 reference check.** Full width, f32, the kernel path
    against the plain path (the batch-norm flags ``never``) from identical
    weights. At full depth, batch 8 x 3 x 224 x 224, the first step: the
    losses agree to 1e-4 and the kernel path's gradients are no farther
    from float64 than twice the plain path's (the f32 gradient at full
    depth is ill-conditioned: the plain path's own is percents from
    float64, printed). With the depth cut to one bottleneck per stage,
    batch 32 x 3 x 64 x 64: the first-step gradients agree to 1e-3 of
    each parameter's float64 gradient, and after three Momentum steps the
    losses, parameters and running statistics agree to 1e-4.
11. **The local-moments kernel.** The cross-rank batch norm's per-rank
    statistics pass (one launch, like the given-statistics backward: the
    last CTAs to arrive sum the partial rows) against its
    plain version at the four ResNet-50 shapes, f32 and bf16 (the
    statistics' tolerance; repeats bit-identical), the training forward's
    mean equal to its sum x 1 / rows bit for bit (the two share one
    summation order); 53 moments and given-statistics backward calls
    alternating as in a dp step, replayed in a CUDA graph equal to the
    eager calls; timed in bf16 beside its plain version,
    ``torch.batch_norm_stats`` on the same data as a channels-last
    ``[N, C, H, W]`` tensor, and its bound.
12. **Data-parallel ResNet-50 (the fourth main path).**
    ``init_parallel_env()`` (NCCL, world size 1), then ``ParallelEngine``
    on ``build_mesh(dp=1)`` over ``resnet50()`` + ``Momentum(1e-3, 0.9)``
    in bf16 at per-rank batch 32 x 224² (``benches.py:91-162``'s dp
    path), two batches staged through ``shard_batch``: two warm-up steps,
    then slope+readback timing. The counters are zeroed just before and
    read just after: every step launches 53 ``local_moments``, 53
    ``fused_bn_norm``, 53 ``norm_bwd`` and no training-mode batch-norm
    kernel, and makes 2 x 53 + 1 all-reduces (one per batch norm each
    way, one gradient bucket). Two more steps under ``torch.profiler``
    count the device's kernels a step (printed) and hold the moments and
    the given-statistics backward to one CUDA launch a call (53 each).
    The loss must be finite and falling.
    Prints step ms, samples/s and MFU beside phase 9's single-device step.
13. **Cross-rank check.** Two ranks spawned on the one card over gloo
    (NCCL refuses two ranks on one device), f32, ResNet-50 at full width
    cut to one bottleneck per stage, global batch 32 x 3 x 64 x 64 (16 per
    rank): after three Momentum steps the losses, parameters and running
    statistics agree to 1e-4 with the world-size-1 engine on the whole
    batch, and the two ranks hold identical parameters. With two or more
    cards the same check runs over NCCL, one rank per card. A failed rank
    fails the run.
14. **The row-softmax kernel.** The eager slice's kernel against its
    plain version at ``[64, 10]`` (LeNet's prediction), ``[32, 1000]``
    (ResNet-50's head), ``[196608, 128]`` (BERT-base's attention scores
    at batch 128), ``[2048, 32000]`` (the serving vocabulary) and the
    ragged ``[1000, 1003]``, in f32 (1e-6 abs), bf16 and f16 (one
    rounding step), half of one row masked to -inf, repeats bit-identical; its
    autograd gradient against plain autograd (1e-6, f32); timed in bf16
    beside its plain version, ``torch.softmax`` and its bound.
15. **Eager LeNet (the fifth main path).** BASELINE config 1
    (``benches.py:52-88``): ``LeNet()`` with seeded weights, ``Adam(1e-3)``,
    two seeded batches of 64 x 1 x 28 x 28 staged with ``to_tensor`` as
    Paddle tensors; ``model(x)``, ``F.cross_entropy``, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``: two warm-up steps, then
    slope+readback timing over the bench's 20 steps with the counters
    zeroed just before and read just after (one fused Adam launch a step,
    no softmax). The loss must be finite and falling. The same loop on a
    twin with plain torch parameters and inputs, in turns, gives the
    facade's host cost. Then a prediction under ``no_grad``,
    ``F.softmax(model(x))``: exactly one softmax launch, rows summing to
    1 within 1e-5, the argmax of the logits. Then, in f32 from identical
    weights, three steps and a prediction on the kernel path against the
    plain path (``fused_softmax``/``fused_adam`` ``never``): losses and
    parameters within 1e-5, probabilities within 1e-6; and a
    ``save``/``load`` of the model and Adam state into a fresh LeNet and
    Adam, whose next step equals the uninterrupted run's bit for bit.
16. **The given-statistics batch norm at YOLOv3's widths.** The
    eval-mode kernel against its plain version at every ``[rows, C]``
    YOLOv3's forward gives it at batch 8 (13 shapes, C from 32 at 416²
    to 1024 at 13²), f32 and bf16, identity and relu, repeats
    bit-identical; timed in f32 and bf16 at seven of them (one a
    resolution, two at 208²) by graph replay beside its plain version,
    ``F.batch_norm``'s eval forward on a channels-last ``[8, C, H, W]``
    view of the same rows and its bytes bound.
17. **YOLOv3 inference (the sixth main path).** BASELINE config 5
    (``benches.py:257-310``): ``yolov3(num_classes=80)`` with seeded
    weights, its 72 batch norms calibrated on one seeded batch (momentum
    0 for one training-mode forward under ``no_grad``: the running
    statistics become that batch's), then ``eval()``; a seeded
    ``[8, 3, 416, 416]`` f32 batch staged on the card once; a warm-up
    forward, then slope+readback timing over 20 forwards with the
    counters zeroed just before and read just after: 72 ``fused_bn_norm``
    launches a forward and no training-mode launch. Heads ``[8, 255, 13,
    13]``, ``[8, 255, 26, 26]``, ``[8, 255, 52, 52]``, finite, each with a
    standard deviation above 1e-2 (a vanishing forward fails). One
    forward under ``torch.profiler`` (a quarter second of host idle at
    each edge of the window; the window must hold all 72 batch-norm
    kernels, and up to three are taken) sorts the device's kernels by kind
    (convolutions, batch norms, leaky ReLU, adds, concat, upsample,
    layout copies) and fails above 3 layout copies (the JAX package's
    ``conv_nhwc`` gate). Then ``model.postprocess`` (``yolo_box`` on the
    card, one copy to the host, ``multiclass_nms`` in numpy), a warm pass
    and a timed one. Prints images/s, step ms, postprocess ms a batch,
    detections in image 0, peak memory and the convolutions' FLOPs as a
    share of the f32 peak (TF32 is off).
18. **YOLOv3 reference check.** Full width and depth, f32, batch 2 x
    416², from identical calibrated weights: the kernel path against the
    plain path (``fused_bn="never"``). Each head within 1e-4 of its max
    abs value; ``yolo_box``'s boxes (over the image size) and scores
    within 1e-4; ``multiclass_nms`` run under the plain flags on the
    kernel path's decoded arrays equal to the kernel path's postprocess.
19. **ERNIE-1.5B pretraining (the seventh main path).** First the fused
    AdamW kernel over ERNIE-1.5B's 398 parameter tensors (1.64 B
    elements) against its plain version in f32 and bf16, timed in f32
    beside it, ``torch.optim.AdamW(fused=True, capturable=True)`` (five
    alternating rounds of graph replays) and its bound, and the engine's
    ``check_finite`` detection and keep-select timed at that scale (the
    keep-select restoring every tensor bit for bit on a bad step). Then
    BASELINE config 4 (``benches.py:195-223``) at full width and depth:
    ``ErnieForPretraining(ernie_1p5b())`` (hidden 2304, 24 layers of 18
    heads of 128, vocabulary 40000; seeded weights, the init timed) +
    ``BertPretrainingCriterion`` + ``AdamW(1e-4)`` through
    ``ParallelEngine(mesh=build_mesh(dp=1, sharding=1), zero_stage=2,
    amp_dtype="bfloat16")`` at batch 4 x 512: a warm-up step, then
    slope+readback timing on the repeated batch with the counters zeroed
    just before and read just after: 24 flash forward, dK/dV and dQ
    launches and 1 fused AdamW launch a step, 50 LayerNorm launches a
    forward. The loss must be finite and falling. Two more steps under
    ``torch.profiler`` give the device's busy time, idle share and top
    kernels. Prints step ms, samples/s, tokens/s, MFU (``benches.py``'s
    ``6 N B S + 12 L B S^2 H`` over 989 TFLOP/s) and peak memory.
20. **ERNIE-1.5B reference check and the engine's controls.** Full width,
    f32, config 4's engine. Depth 2 at batch 2 x 512 (ragged padding):
    three steps on the kernel path within 1e-4 of three on the plain path
    (losses and parameters; the key biases within 3 x lr), as phase 7.
    Depth 4 with ``grad_accum=2`` (micro-batches of 2 x 512),
    ``clip_global_norm=1.0``, ``check_finite=True`` and a
    ``LinearWarmup(PolynomialDecay(...))`` schedule: ``step_many`` over 4
    batches equals 4 ``step`` calls of a twin engine bit for bit (losses,
    flags, parameters, moments, step counts, schedules), the clipped
    gradient's norm is at most 1, and a batch whose second micro-batch
    scales its loss by NaN comes back ``.bad`` with every parameter,
    moment and the step count unchanged bit for bit; the next step trains.

21. **BERT-base fine-tuning in eager dygraph (the eighth main path).**
    BASELINE config 3's model at full width and depth, f32 (TF32 off),
    the GLUE settings of Devlin et al. 2018 (batch 32 x 128 with ragged
    padding, lr 2e-5): a seeded ``BertForPretraining`` saved with
    ``paddle.save(model.state_dict())`` warm-starts
    ``BertForSequenceClassification`` through ``set_state_dict(
    paddle.load(path))`` (``missing`` exactly the classifier head's,
    ``unexpected`` exactly the pretraining heads'); its head has
    ``ParamAttr(learning_rate=10)``; ``AdamW`` over ``LinearWarmup(
    PolynomialDecay(2e-5))`` with PaddleNLP's decay filter by parameter
    name; hidden dropout 0.1, attention dropout 0 (the flash kernels
    carry none). Each step is ``loss.backward(); opt.step(); sched.step();
    opt.clear_grad()`` on Paddle tensors. Two warm-up steps, then
    slope+readback timing over 30 with the counters zeroed just before
    and read just after: 12 flash forward, dK/dV and dQ launches and one
    fused AdamW a step, 25 LayerNorm launches a forward; the eval-mode
    loss on the staged batches must fall. The same loop on plain tensors,
    in turns, gives the facade's host ms a step; two steps under
    ``torch.profiler`` the busy time and idle share. A ``save`` ->
    ``load`` -> ``set_state_dict`` of model and optimizer into a fresh
    classifier resumes bit for bit, and one step with decay against the
    same step without leaves every parameter the filter excludes (biases
    and norms) bit-equal. Prints step ms, samples/s, tokens/s, MFU over
    the f32 peak and peak memory.
22. **The fine-tuning reference check.** Depth 2, batch 8 x 128, f32,
    dropout 0: three eager steps of phase 21's loop on the kernel path
    within 1e-4 of the plain path (losses and parameters; the key biases
    within 3 x lr, as phase 7).
23. **The op namespace on the card.** Every case of
    ``tests/test_torch_op_cases.py`` (each public op of ``ops.math_ops``,
    ``ops.manip_ops`` and ``ops.linalg_ops`` and the Tensor methods, at
    the parity tests' small shapes) on CUDA Paddle tensors against the
    same call on CPU Paddle tensors: values (10x the case's CPU tolerance,
    at least 1e-5: CUDA's libraries against the CPU's), dtypes, the
    gradients of differentiable ones, and every output tensor on the card
    (no op moves to the CPU). Decompositions are held to their
    reconstructions. ``matmul_int8`` inside ``torch._int_mm``'s rules
    equals the CPU's int32 product, and outside them raises
    ``InvalidArgumentError``; the random ops draw on the card with the
    right shape, dtype and support, repeat under ``paddle.seed`` and under
    a CUDA ``generator``. Prints one line: ops and cases checked, and
    every failure.
24. **BERT-base fine-tuning in Paddle idiom.** Phase 21's model (warm
    start, full width and depth, f32) after a few steps, evaluated
    through the op namespace on staged batches of 32 x 128:
    ``paddle.argmax(logits, axis=-1)``, ``paddle.equal(pred,
    label).astype("float32").mean()`` per batch and over
    ``paddle.concat`` of every batch's logits; the counters zeroed just
    before the eval loop and read just after (25 LayerNorm and 12 flash
    forward launches a forward). A batch cut by ``x.split(2, 0)`` (two
    halves of 16, Paddle's reading) gives logits that, joined by
    ``paddle.concat``, equal the whole batch's within 1e-4. Prints the
    accuracy, eval ms a batch and the launches.

Before the last line it prints one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 1234
VOCAB, D_MODEL, HEADS, LAYERS, MAX_SEQ, FFN = 32000, 512, 8, 12, 512, 128
SLOTS, PAGE = 16, 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (published peak)
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
PA_TOL, LN_TOL, LOGIT_TOL = 2e-5, 1e-5, 1e-3
# BERT-base pretraining (bench.py:186-282)
BERT_VOCAB, BERT_HIDDEN, BERT_LAYERS, BERT_HEADS = 30522, 768, 12, 12
BATCH, SEQ, LR = 128, 128, 1e-4
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores (published)
# f32 flash against its plain version: the same products summed in
# another order (64-term dots, 128-key softmax sums); backward adds two
# chained products
FLASH_TOL, FLASH_BWD_TOL = 1e-5, 1e-4
# bf16 flash: one bf16 rounding step of the value plus the f32 difference
FLASH_BF16_ABS = 1e-4
# Adam: the JAX package's tolerance for its kernel (rtol 1e-6, atol 1e-7);
# the per-tensor learning-rate scales the kernel check cycles through
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
ADAM_SCALES = (1.0, 0.5, 0.0, 2.0, 10.0)
# training reference check (f32, depth 2, 3 steps): the losses and the
# params of the kernel path and the plain path agree to REF_TOL; the
# attention key bias is held to STEPS * lr instead (its gradient is 0 in
# exact arithmetic, so Adam moves it by rounding noise over eps)
REF_TOL, REF_STEPS = 1e-4, 3
# bf16 outputs: kernel and plain version both round an f32 result to bf16,
# so they may differ by one rounding step, at most 2^-7 of the value
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5
# ResNet-50 (benches.py:91-162): per-device batch 32 at 224 x 224,
# Momentum(1e-3, 0.9); 53 batch norms; 4.1e9 x 3 FLOPs per sample
RN_BATCH, RN_IMG, RN_LR, RN_BNS = 32, 224, 1e-3, 53
RN_FLOPS_PER_SAMPLE = 4.1e9 * 3.0
# ResNet-50's stem, layer 2, layer 3 and layer 4 at 32 images a card
# (6272 rows is the most frequent row count of a step: 19 of 53 batch
# norms; 1568 the next, 9)
BN_SHAPES = ((401408, 64), (25088, 512), (6272, 1024), (1568, 2048))
BN_LAYER4 = [1568, 2048]
# batch-norm kernels against their plain versions: y and dx differ by the
# statistics' rounding (sums in another order) times |xhat * gamma|, so
# an abs tolerance in f32, and one bf16 rounding step beyond it in bf16;
# the statistics and dgamma/dbeta are sums over up to 4e5 rows in
# another order: relative 1e-4, with an absolute floor of 1e-5 * sqrt(rows)
# for sums that cancel to near zero
BN_ABS, BN_STAT_RTOL, BN_STAT_FLOOR = 5e-5, 1e-4, 1e-5
# ResNet-50 reference check (f32, kernel path against plain path; see
# resnet_reference_check): full depth, first step, the kernel path's
# gradients at most RN_F64_FACTOR times as far from float64 as the plain
# path's; depth cut to one bottleneck per stage, first-step gradients
# within RN_GRAD_TOL of each parameter's float64 gradient norm, and
# REF_STEPS steps within REF_TOL
RN_REF_FULL = {"batch": 8, "img": 224}
RN_REF_CUT = {"batch": 32, "img": 64, "blocks": 1}
RN_F64_FACTOR, RN_GRAD_TOL = 2.0, 1e-3
# data-parallel ResNet-50: ranks of the cross-rank check, its time limit
DP_RANKS, DP_RANK_TIMEOUT_S = 2, 300
# row softmax: LeNet's [64, 10], ResNet-50's head [32, 1000], BERT-base's
# attention scores at batch 128 (128 * 12 * 128 rows of 128), the serving
# vocabulary [2048, 32000] and a ragged width. f32: the same max, exps and
# a sum in another order (the wide rows' online sum) agree to SM_TOL; bf16
# and f16: one rounding step of the output (BF16_REL, F16_REL)
SM_SHAPES = ((64, 10), (32, 1000), (196608, 128), (2048, 32000),
             (1000, 1003))
SM_TOL, F16_REL = 1e-6, 2.0 ** -10
# eager LeNet (BASELINE config 1, benches.py:52-88): batch 64, Adam(1e-3),
# the bench's 20 timed steps; f32 kernel-vs-plain check over 3 steps
LENET_BATCH, LENET_STEPS, LENET_REF_STEPS, LENET_REF_TOL = 64, 20, 3, 1e-5
# YOLOv3 inference (BASELINE config 5, benches.py:257-310): batch 8 x 3 x
# 416², 80 classes, f32, the bench's 20 timed forwards; 72 batch norms
YOLO_BATCH, YOLO_IMG, YOLO_CLASSES, YOLO_STEPS, YOLO_BNS = 8, 416, 80, 20, 72
# every [rows, C] its batch norms get at batch 8 (416², 208², 104², 52²,
# 26², 13²), and the seven timed (one or two widths a resolution)
YOLO_BN_SHAPES = ((1384448, 32), (346112, 64), (346112, 32), (86528, 128),
                  (86528, 64), (21632, 256), (21632, 128), (5408, 512),
                  (5408, 256), (5408, 128), (1352, 1024), (1352, 512),
                  (1352, 256))
YOLO_BN_TIMED = ((1384448, 32), (346112, 64), (346112, 32), (86528, 128),
                 (21632, 256), (5408, 512), (1352, 1024))
# the JAX package's conv_nhwc layout gate: at most 3 boundary transposes;
# a calibrated head's standard deviation is well above 0
YOLO_MAX_COPIES, YOLO_MIN_STD = 3, 1e-2
# the profiled forward: host idle at each edge of the profiler's window
# (seconds), and the windows taken before one that misses kernels fails
YOLO_PROFILE_GAP_S, YOLO_PROFILE_WINDOWS = 0.25, 3
# kernel path against plain path (f32, batch 2): each head within 1e-4 of
# its max abs value, decoded boxes (over the image size) and scores 1e-4
YOLO_REF_BATCH, YOLO_REF_TOL = 2, 1e-4
# ERNIE-1.5B pretraining (BASELINE config 4, benches.py:195-223):
# ernie_1p5b() at full width and depth, AdamW(1e-4), bf16, batch 4 x seq
# 512, ParallelEngine on build_mesh(dp=1, sharding=1) with zero_stage=2
ERNIE_VOCAB, ERNIE_HIDDEN, ERNIE_LAYERS, ERNIE_HEADS = 40000, 2304, 24, 18
ERNIE_FFN, ERNIE_POS = 9216, 2048
ERNIE_BATCH, ERNIE_SEQ, ERNIE_LR = 4, 512, 1e-4
# its f32 reference check: depth 2 at batch 2 x 512 (kernel path against
# plain path, REF_TOL over REF_STEPS steps), then the engine's controls
# at depth 4: grad_accum 2 x micro-batch 2, the global-norm clip, the
# finite check and a warm-up over a polynomial decay
ERNIE_REF_BATCH, ERNIE_CTRL_DEPTH, ERNIE_CTRL_K = 2, 4, 4
# BERT-base fine-tuning in eager dygraph (BASELINE config 3's model at full
# width and depth, f32; batch 32 x 128 and lr 2e-5 are the GLUE settings
# of Devlin et al. 2018, appendix A.3): AdamW with PaddleNLP's decay
# filter over a warm-up and a polynomial decay, the classifier's weight at
# FT_HEAD_LR times the rate, hidden dropout 0.1 and attention dropout 0
# (the flash kernels carry no dropout); FT_STEPS timed steps, the host
# comparison over FT_HOST_STEPS; its reference check at depth 2, batch
# 8 x 128, dropout 0
FT_BATCH, FT_SEQ, FT_LR, FT_HEAD_LR, FT_CLASSES = 32, 128, 2e-5, 10.0, 2
FT_STEPS, FT_HOST_STEPS, FT_DECAY_STEPS = 30, 10, 400
FT_REF_DEPTH, FT_REF_BATCH = 2, 8


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0].strip()


def graph_time_ms(calls, reps=20):
    """Mean device time of one call: the calls are captured once into a
    CUDA graph, the graph is replayed ``reps`` times between CUDA events.
    Each call runs once eagerly first (lazy init, allocations)."""
    for f in calls:
        f()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def graph_replay_equal(fn, eager, name):
    """Capture ``fn()`` (a tensor or a tuple of them) into a CUDA graph,
    replay it twice and check that each replay's outputs equal ``eager``,
    the same call's eager outputs, bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    as_tuple = lambda t: t if isinstance(t, tuple) else (t,)  # noqa: E731
    for i in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(as_tuple(captured),
                                                    as_tuple(eager))),
              f"{name}: graph replay {i + 1} differs from the eager call")
    del graph


# the tensor-core flash kernels, by library and by a piece of their names
TC_KERNELS = {"flash_attention": ("flash_fwd_tc_kernel",),
              "flash_attention_bwd": ("flash_bwd_dkv_tc_kernel",
                                      "flash_bwd_dq_tc_kernel")}


def ptxas_usage(report, piece):
    """{instantiation: {"registers": n, "spill_bytes": n}} of the kernels
    whose mangled name holds ``piece``, from nvcc's ``-Xptxas -v``."""
    out, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if piece in line else None
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out.setdefault(fn, {})["spill_bytes"] = nums[1] + nums[2]
        elif fn and "Used" in line and "registers" in line:
            out.setdefault(fn, {})["registers"] = int(
                line.split("Used")[1].split()[0])
    return out


def tensor_core_report(build, libs):
    """HMMA instructions in the SASS of each tensor-core flash kernel
    (``cuobjdump --dump-sass`` of the built library) and its registers and
    spills; fails the run when one holds no HMMA."""
    import os
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    report = {}
    for lib, pieces in TC_KERNELS.items():
        sass = subprocess.run([cuobjdump, "--dump-sass", str(libs[lib])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for piece in pieces:
            counts, fn = {}, None
            for line in sass.splitlines():
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                    if piece not in fn:
                        fn = None
                    elif fn not in counts:
                        counts[fn] = 0
                elif fn and "HMMA" in line:
                    counts[fn] += 1
            check(counts and all(counts.values()),
                  f"{piece}: no HMMA in its SASS ({counts})")
            usage = ptxas_usage(build.build_log(lib) or "", piece)
            report[piece] = [{"function": f, "hmma": n, **usage.get(f, {})}
                             for f, n in sorted(counts.items())]
            log(f"sass {piece}: " + "; ".join(
                f"{r['function'][:60]} HMMA={r['hmma']} registers="
                f"{r.get('registers')} spill_bytes={r.get('spill_bytes')}"
                for r in report[piece]))
    return report


# the batch-norm kernels, by library and by a piece of their names
BN_KERNELS = {"fused_bn": ("train_fwd_kernel", "moments_kernel",
                           "normalize_kernel"),
              "fused_bn_bwd": ("train_bwd_kernel", "norm_bwd_kernel")}


def bn_register_report(build):
    """Registers and spill bytes of every batch-norm kernel instantiation
    (nvcc's ``-Xptxas -v`` of this process's build), printed one line per
    kernel; fails the run when a kernel has no report."""
    report = {}
    for lib, pieces in BN_KERNELS.items():
        for piece in pieces:
            usage = ptxas_usage(build.build_log(lib) or "", piece)
            check(usage, f"{lib} {piece}: no ptxas report")
            report[f"{lib}.{piece}"] = [{"function": f, **u} for f, u
                                        in sorted(usage.items())]
            log(f"ptxas_bn {lib}.{piece}: " + "; ".join(
                f"{f[:70]} registers={u.get('registers')} "
                f"spill_bytes={u.get('spill_bytes')}"
                for f, u in sorted(usage.items())))
    return report


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def paged_bases(rng, w, kind):
    """Slot lengths before the window: ``random`` in 0..500 with two
    parked slots (3 and 11: base 0, their rows on page 0); ``skewed``, one
    slot at 496 and 15 shorter than one split of the kernel; ``long``,
    every slot within 16 of the cache's end."""
    if kind == "skewed":
        base = rng.integers(0, 24, SLOTS)
        base[5] = 496
    elif kind == "long":
        base = MAX_SEQ - w - rng.integers(0, 16, SLOTS)
    else:
        base = rng.integers(0, min(500, MAX_SEQ - w) + 1, SLOTS)
        base[[3, 11]] = 0
    return base.astype(np.int32)


def paged_case(rng, dev, w, n_pools, kind="random"):
    """Serving-shaped paged attention inputs: ``n_pools`` K/V pool pairs
    [513, 16, 8, 64] (one per layer, so timing does not sit in L2), a
    [16, 32] table with each slot's chain drawn from a shuffled free list
    and the rest parked on page 0, and the bases of ``paged_bases``."""
    hd = D_MODEL // HEADS
    mpps = MAX_SEQ // PAGE
    n_pages = SLOTS * mpps + 1
    q = torch.from_numpy(rng.standard_normal(
        (SLOTS, w, HEADS, hd)).astype(np.float32)).to(dev)
    pools = [(torch.randn(n_pages, PAGE, HEADS, hd, device=dev),
              torch.randn(n_pages, PAGE, HEADS, hd, device=dev))
             for _ in range(n_pools)]
    base = paged_bases(rng, w, kind)
    table = np.zeros((SLOTS, mpps), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for s in range(SLOTS):
        if kind == "random" and s in (3, 11):
            continue  # parked slot: every entry stays on page 0
        n = -(-(int(base[s]) + w) // PAGE)
        table[s, :n] = [free.pop() for _ in range(n)]
    return (q, pools, torch.from_numpy(table).to(dev),
            torch.from_numpy(base).to(dev))


def paged_bound_ms(q, kp, base, w):
    """Least time for the work the kernel must do on these inputs: read q,
    the K/V rows some query row can see (positions < base + W, one
    head's row is its own 256 B, so no whole page is needed), the table
    entries that map them and the bases, write out; ~4 flops per (query
    row, visible key, dim) for QK^T and PV."""
    s_, _, h, d = q.shape
    b = base.cpu().numpy().astype(np.int64)
    rows = np.minimum(b + w, MAX_SEQ)
    live_pages = -(-rows // PAGE)
    kv_bytes = int(rows.sum()) * h * d * kp.element_size() * 2
    io_bytes = (2 * q.numel() * q.element_size() + int(live_pages.sum()) * 4
                + s_ * 4)
    visible = sum(int(b[s] + 1 + i) for s in range(s_) for i in range(w))
    flops = 4.0 * visible * h * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ln_bound_ms(rows, h):
    t_bytes = (2 * rows * h * 4 + 2 * h * 4) / HBM_BYTES_PER_S
    t_ops = 8.0 * rows * h / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_phase(dev, rng):
    """Paged attention against its plain version at the decode step's
    shape, timed beside the plain version and its bound; one dict per
    case, the decode step's first."""
    from paddle1_tpu_torch.ops import paged_attention as pa
    cases = []
    # the decode step (the line's main case), a W=4 window, f32 q over
    # bf16 pools (a bf16 KV cache under an f32 model), one long slot among
    # short ones and every slot long; each repeated bit for bit, the main
    # case also as a CUDA graph replayed twice
    for w, kv_dtype, kind in ((1, torch.float32, "random"),
                              (4, torch.float32, "random"),
                              (1, torch.bfloat16, "random"),
                              (1, torch.float32, "skewed"),
                              (1, torch.float32, "long")):
        # the new cases draw from their own stream, so the others' inputs
        # stay those of earlier runs
        q, pools, table, base = paged_case(
            rng if kind == "random" else np.random.default_rng(
                SEED + len(cases)), dev, w, n_pools=LAYERS, kind=kind)
        pools = [(kp.to(kv_dtype), vp.to(kv_dtype)) for kp, vp in pools]
        live = base >= 0
        tag = f"W={w} kv={str(kv_dtype).split('.')[-1]} bases={kind}"
        errs = []
        for kp, vp in pools[:2]:
            got = pa.paged_attention(q, kp, vp, table, base)
            want = pa.paged_attention_ref(q, kp, vp, table, base)
            torch.cuda.synchronize()
            errs.append(float((got - want)[live].abs().max()))
            check(bool(torch.isfinite(got).all()) and got.dtype == q.dtype,
                  f"paged_attention {tag}: non-finite output or a dtype "
                  f"other than q's")
            check(torch.equal(pa.paged_attention(q, kp, vp, table, base),
                              got), f"paged_attention {tag}: a repeat "
                  "differs")
        if not cases:
            kp, vp = pools[0]
            graph_replay_equal(
                lambda: pa.paged_attention(q, kp, vp, table, base),
                pa.paged_attention(q, kp, vp, table, base),
                f"paged_attention {tag}")
        err = max(errs)
        check(err <= PA_TOL, f"paged_attention {tag}: max abs err {err} > "
              f"{PA_TOL}")
        ms = graph_time_ms([lambda kp=kp, vp=vp: pa.paged_attention(
            q, kp, vp, table, base) for kp, vp in pools])
        plain = graph_time_ms([lambda kp=kp, vp=vp: pa.paged_attention_ref(
            q, kp, vp, table, base) for kp, vp in pools])
        bound, by = paged_bound_ms(q, pools[0][0], base, w)
        cases.append(dict(shape=f"q{list(q.shape)} pool{list(pools[0][0].shape)}"
                          f" table{list(table.shape)}", window=w,
                          kv_dtype=str(kv_dtype), bases=kind,
                          max_base=int(base.max()), max_abs_err=err, ms=ms,
                          plain_ms=plain, bound_ms=bound, bound_by=by,
                          library_ms=None))
        log(f"paged_attention {tag}: max_abs_err={err:.3e} kernel={ms:.5f}ms"
            f" plain={plain:.5f}ms bound={bound:.5f}ms ({by})")
        del pools
    return cases


def kernel_phase(dev):
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(SEED)
    out = {"paged_attention": paged_phase(dev, rng)}

    cases = []
    # the decode step, a prefill, a ragged width and one past the
    # warp-per-row path (1024)
    for rows, h in ((SLOTS, D_MODEL), (512, D_MODEL), (37, 1000),
                    (64, 4096)):
        x = torch.from_numpy((rng.standard_normal((rows, h)) * 2 + 0.3)
                             .astype(np.float32)).to(dev)
        w_ = torch.from_numpy(rng.standard_normal(h).astype(np.float32)
                              ).to(dev)
        b_ = torch.from_numpy(rng.standard_normal(h).astype(np.float32)
                              ).to(dev)
        got = ln.fused_layer_norm(x, w_, b_)
        want = ln.layer_norm_ref(x, w_, b_)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= LN_TOL, f"layer_norm rows={rows} H={h}: max abs err "
              f"{err} > {LN_TOL}")
        ms = graph_time_ms([lambda: ln.fused_layer_norm(x, w_, b_)] * 24)
        plain = graph_time_ms([lambda: ln.layer_norm_ref(x, w_, b_)] * 24)
        lib = graph_time_ms([lambda: torch.nn.functional.layer_norm(
            x, (h,), w_, b_, 1e-5)] * 24)
        bound, by = ln_bound_ms(rows, h)
        cases.append(dict(shape=f"x[{rows}, {h}]", max_abs_err=err, ms=ms,
                          plain_ms=plain, bound_ms=bound, bound_by=by,
                          library_ms=lib))
        log(f"layer_norm rows={rows} H={h}: max_abs_err={err:.3e} "
            f"kernel={ms:.5f}ms plain={plain:.5f}ms library={lib:.5f}ms "
            f"bound={bound:.5f}ms ({by})")
    out["layer_norm"] = cases

    # the kernels' second storage type, one decode-shaped case each
    bf = torch.bfloat16
    q, pools, table, base = paged_case(rng, dev, 1, n_pools=1)
    kp, vp = (t.to(bf) for t in pools[0])
    pairs = {"paged_attention": (
        pa.paged_attention(q.to(bf), kp, vp, table, base),
        pa.paged_attention_ref(q.to(bf), kp, vp, table, base))}
    x = torch.randn(SLOTS, D_MODEL, device=dev).to(bf)
    w_, b_ = (torch.randn(D_MODEL, device=dev).to(bf) for _ in range(2))
    pairs["layer_norm"] = (ln.fused_layer_norm(x, w_, b_),
                           ln.layer_norm_ref(x, w_, b_))
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        check(got.dtype == bf, f"{name} bf16: output dtype {got.dtype}")
        got, want = got.float(), want.float()
        excess = float(((got - want).abs() - BF16_REL * want.abs()).max())
        check(excess <= BF16_ABS, f"{name} bf16: differs from the plain "
              f"version by more than one bf16 rounding step ({excess})")
        out[name + "_bf16"] = {"shape": list(got.shape),
                               "max_abs_err": float((got - want).abs().max()),
                               "excess_over_rounding": excess}
        log(f"{name} bf16: max_abs_err={out[name + '_bf16']['max_abs_err']:.3e}"
            f" (within one bf16 rounding step)")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path


def make_requests(rng):
    lens = [5, 17, 33, 64, 90, 128, 150, 200, 12, 48]
    reqs = []
    for i, n in enumerate(lens):
        prompt = rng.integers(3, VOCAB, n).tolist()
        kw = dict(max_new_tokens=int(32 + (i * 7) % 33))
        if i % 2:
            kw.update(temperature=0.8, top_k=40, seed=100 + i)
        reqs.append((prompt, kw))
    return reqs


def serve(srv, reqs):
    """Staggered arrivals: 4 requests, then 3 more once the first has
    streamed 4 tokens, then the rest once it has 12."""
    streams = []
    waves = [(reqs[:4], 0), (reqs[4:7], 4), (reqs[7:], 12)]
    for wave, after in waves:
        t0 = time.monotonic()
        while streams and len(streams[0].tokens) < after and \
                not streams[0].done() and time.monotonic() - t0 < 120:
            time.sleep(0.001)
        streams += [srv.submit(p, **kw) for p, kw in wave]
    outs = [s.result(timeout=300) for s in streams]
    return streams, outs


def serving_phase(dev):
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    from paddle1_tpu_torch.serving import (CausalLM, GenerationEngine,
                                           GenerationServer)
    gen = torch.Generator().manual_seed(SEED)
    lm = CausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, dim_feedforward=FFN,
                  num_layers=LAYERS, max_seq=MAX_SEQ, generator=gen)
    check(all(p.device.type == "cuda" for p in lm.parameters()),
          "CausalLM did not default to the card")
    n_params = sum(p.nelement() for p in lm.parameters())
    eng = GenerationEngine(lm, slots=SLOTS, max_seq=MAX_SEQ, eos_id=2,
                           paged=True, page_size=PAGE)
    srv = GenerationServer(eng, queue_depth=64, warmup=True).start()
    reqs = make_requests(np.random.default_rng(SEED + 1))
    torch.cuda.synchronize()

    # the warm-up's steps ran before the counters were zeroed
    steps0 = eng.decode_dispatch_count
    prefills0 = sum(eng.prefill_dispatch_counts.values())
    pa.paged_attention.launches = 0
    ln.fused_layer_norm.launches = 0
    t0 = time.perf_counter()
    streams, outs = serve(srv, reqs)
    rep = srv.drain(timeout=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.paged_attention.launches,
                "layer_norm": ln.fused_layer_norm.launches}

    check(rep["fatal"] is None, f"generation loop died: {rep['fatal']}")
    check(rep["unaccounted"] == 0, f"unaccounted={rep['unaccounted']}")
    check(rep["kv_pages_owed"] == 0, f"kv_pages_owed={rep['kv_pages_owed']}")
    check(rep["tokens_owed"] == 0, f"tokens_owed={rep['tokens_owed']}")
    check(rep["completed"] == len(reqs), f"completed {rep['completed']} of "
          f"{len(reqs)}")
    for st, out, (p, kw) in zip(streams, outs, reqs):
        check(st.finish_reason in ("eos", "length"),
              f"stream finished {st.finish_reason}")
        check(1 <= len(out) <= kw["max_new_tokens"], "bad stream length")
        check(all(0 <= t < VOCAB for t in out), "token outside the vocab")
    steps = rep["decode_dispatches"] - steps0
    prefills = sum(rep["prefill_dispatch_counts"].values()) - prefills0
    check(launches["paged_attention"] == LAYERS * steps,
          f"paged_attention launched {launches['paged_attention']} times, "
          f"want {LAYERS} per decode step x {steps}")
    check(launches["layer_norm"] == 2 * LAYERS * (steps + prefills),
          f"layer_norm launched {launches['layer_norm']} times, want "
          f"{2 * LAYERS} per step x {steps + prefills} steps")
    h = srv.metrics.snapshot()["histograms"]
    summary = {
        "serving": "paged", "params": n_params, "requests": len(reqs),
        "tokens_generated": rep["tokens_generated"],
        "decode_steps": steps, "prefills": prefills,
        "wall_s": wall, "tokens_per_s": rep["tokens_generated"] / wall,
        "decode_step_ms_mean": h["decode_step_ms"]["mean"],
        "decode_step_ms_p50": h["decode_step_ms"]["p50"],
        "decode_step_ms_p99": h["decode_step_ms"]["p99"],
        "prefill_ms_mean": h["prefill_ms"]["mean"],
        "finish": [s.finish_reason for s in streams],
        "launches": launches, "unaccounted": rep["unaccounted"],
        "kv_pages_owed": rep["kv_pages_owed"],
    }
    log(json.dumps(summary))
    return lm, eng, reqs, outs, launches, steps


# ---------------------------------------------------------------------------
# phase 4: reference checks


def plain_logits(lm, seq, dev):
    """The plain-version forward on the card: no cache, dense causal
    attention, plain LayerNorm; no hand-written kernel runs."""
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    before = (ln.fused_layer_norm.launches, pa.paged_attention.launches)
    with flags_guard(fused_layer_norm="never",
                     pallas_paged_attention="never"), torch.inference_mode():
        lg = lm(torch.tensor([seq], device=dev))[0].float()
    check((ln.fused_layer_norm.launches, pa.paged_attention.launches)
          == before, "the plain-version forward launched a kernel")
    return lg


def teacher_forced_check(lm, eng, prompt, served, dev):
    """Re-run ``prompt`` alone through the engine (kernel path) and
    compare each step's logits with the plain-version forward."""
    eng_logits = []
    toks = [eng.prefill(0, np.asarray(prompt, np.int32), 0.0, 0, 0)]
    eng_logits.append(eng.last_prefill_logits.clone())
    active = np.zeros([eng.slots], bool)
    active[0] = True
    for _ in range(len(served) - 1):
        t, _ = eng.decode(active)
        toks.append(int(t[0, 0]))
        eng_logits.append(eng.last_logits[0].clone())
    eng.release(0)
    check(toks == served, f"greedy request alone {toks[:8]}... != served "
          f"{served[:8]}...")
    seq = list(prompt) + served[:-1]
    ref = plain_logits(lm, seq, dev)[len(prompt) - 1:]
    got = torch.stack(eng_logits)
    err = float((got - ref).abs().max())
    check(err <= LOGIT_TOL, f"teacher-forced logits differ by {err} > "
          f"{LOGIT_TOL}")
    return err, len(served)


def dense_check(lm_state, dev):
    """Dense slot cache (``paged=False``) at depth 2: serve 4 requests,
    drain, and hold the greedy streams to the plain-version forward."""
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    from paddle1_tpu_torch.serving import (CausalLM, GenerationEngine,
                                           GenerationServer)
    lm = CausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, dim_feedforward=FFN,
                  num_layers=2, max_seq=MAX_SEQ)
    lm.load_state_dict({k: v for k, v in lm_state.items()
                        if not k.startswith("encoder.layers.")
                        or int(k.split(".")[2]) < 2})
    eng = GenerationEngine(lm, slots=SLOTS, max_seq=MAX_SEQ, eos_id=2,
                           paged=False)
    srv = GenerationServer(eng).start()
    rng = np.random.default_rng(SEED + 2)
    reqs = [(rng.integers(3, VOCAB, n).tolist(), kw) for n, kw in (
        (9, dict(max_new_tokens=24)),
        (70, dict(max_new_tokens=24, temperature=0.9, top_k=20, seed=5)),
        (130, dict(max_new_tokens=24)),
        (31, dict(max_new_tokens=24, temperature=0.7, seed=6)))]
    pa_before = pa.paged_attention.launches
    ln_before = ln.fused_layer_norm.launches
    outs = [s.result(timeout=300) for s in
            [srv.submit(p, **kw) for p, kw in reqs]]
    rep = srv.drain(timeout=300)
    torch.cuda.synchronize()
    check(rep["unaccounted"] == 0 and rep["tokens_owed"] == 0,
          f"dense drain report {rep}")
    check(ln.fused_layer_norm.launches > ln_before,
          "dense run did not launch the LayerNorm kernel")
    check(pa.paged_attention.launches == pa_before,
          "dense run launched the paged kernel")
    worst_gap = 0.0
    for (p, kw), out in zip(reqs, outs):
        if kw.get("temperature"):
            continue
        lg = plain_logits(lm, list(p) + out[:-1], dev)[len(p) - 1:]
        for i, tok in enumerate(out):
            gap = float(lg[i].max() - lg[i, tok])
            worst_gap = max(worst_gap, gap)
    check(worst_gap <= LOGIT_TOL, f"dense greedy token is {worst_gap} below"
          " the plain forward's argmax")
    return {"dense_depth": 2, "requests": len(reqs),
            "tokens": rep["tokens_generated"], "worst_argmax_gap": worst_gap}


# ---------------------------------------------------------------------------
# phase 5: the training kernels against their plain versions


def event_time_ms(fn, reps=20):
    """Mean time of one eager call between CUDA events (for library calls
    that do not capture into a graph, such as an autograd backward or an
    optimizer step); warmed up first."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bf16_excess(got, want):
    """How far |got - want| exceeds one bf16 rounding step of want."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - BF16_REL * want.abs()).max())


def bound(bytes_, flops, flops_per_s):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bounds(q, keep):
    """Bounds of the three flash kernels on these inputs: each reads its
    inputs once and writes its outputs once; the work counts only the
    (query, key) pairs the keep-mask leaves visible: 4 D flops per pair
    forward (QK^T, PV), 8 D for dK/dV (S, dP, dV, dK), 6 D for dQ."""
    b, n, h, d = q.shape
    el = q.element_size()
    pairs = float(keep.sum().item()) * n * h     # per batch row: Nq * kept
    mask_b = keep.numel()
    rows_f32 = b * h * n * 4                      # one f32 per query row
    t = q.numel() * el
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    return {
        "fwd": bound(4 * t + rows_f32 + mask_b, 4.0 * d * pairs, peak),
        "dkv": bound(6 * t + 2 * rows_f32 + mask_b, 8.0 * d * pairs, peak),
        "dq": bound(5 * t + 2 * rows_f32 + mask_b, 6.0 * d * pairs, peak),
    }


BERT_ATTN = (BATCH, SEQ, BERT_HEADS, BERT_HIDDEN // BERT_HEADS)
# ERNIE-1.5B (BASELINE config 4, benches.py:195-218): batch 4, seq 512,
# 18 heads of 128 (hidden 2304)
ERNIE_ATTN = (ERNIE_BATCH, ERNIE_SEQ, ERNIE_HEADS,
              ERNIE_HIDDEN // ERNIE_HEADS)
# BERT-base fine-tuning (phase 21): f32, batch 32, seq 128, ragged padding
FT_ATTN = (FT_BATCH, FT_SEQ, BERT_HEADS, BERT_HIDDEN // BERT_HEADS)


def flash_case(dev, dtype, seed, n_sets=1, shape=BERT_ATTN):
    """``n_sets`` independent (q, k, v, dout) sets at ``shape`` (the
    BERT-base attention shape by default), a keep-mask with ragged tails
    and batch row 0 fully padded, and the all-keep mask the main path's
    batch gives."""
    b, n = shape[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    sets = [[torch.randn(*shape, device=dev, generator=g).to(dtype)
             for _ in range(4)] for _ in range(n_sets)]
    lens = np.random.default_rng(seed).integers(32, n + 1, b)
    lens[0] = 0
    keep = torch.from_numpy(np.arange(n)[None, :] < lens[:, None]).to(dev)
    return sets, keep, torch.ones(b, n, dtype=torch.bool, device=dev)


def flash_check(dev):
    """Hold the three flash kernels to their plain versions in f32 and
    bf16 (padded tails, one fully padded row; causal in both; both also
    at ERNIE-1.5B's [4, 512, 18, 128]). The bf16 cases, which run the
    tensor-core kernels, must repeat bit for bit."""
    from paddle1_tpu_torch.ops import flash_attention as fa
    from paddle1_tpu_torch.ops import flash_attention_bwd as fb
    errs = {"fwd": [], "dkv": [], "dq": []}
    for dtype, causal, shape in ((torch.float32, False, BERT_ATTN),
                                 (torch.float32, True, BERT_ATTN),
                                 (torch.bfloat16, False, BERT_ATTN),
                                 (torch.bfloat16, True, BERT_ATTN),
                                 (torch.float32, False, ERNIE_ATTN),
                                 (torch.bfloat16, False, ERNIE_ATTN),
                                 (torch.float32, False, FT_ATTN)):
        scale = 1.0 / shape[-1] ** 0.5
        sets, keep, _ = flash_case(dev, dtype, SEED + 3, shape=shape)
        q, k, v, do = sets[0]
        out, lse = fa.flash_fwd(q, k, v, scale, causal, keep)
        ro, rl = fa.flash_attention_ref(q, k, v, scale, causal, keep)
        delta = (do.float() * ro.float()).sum(-1).transpose(1, 2)
        dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, causal,
                                  keep)
        dq = fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, causal, keep)
        rq, rk, rv = fa.flash_bwd_ref(q, k, v, ro, rl, do, scale, causal,
                                      keep)
        torch.cuda.synchronize()
        tag = f"{str(dtype).split('.')[-1]} causal={causal} {list(shape)}"
        if dtype == torch.bfloat16:
            again = (*fa.flash_fwd(q, k, v, scale, causal, keep),
                     *fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, causal,
                                       keep),
                     fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, causal,
                                     keep))
            check(all(torch.equal(a, b_)
                      for a, b_ in zip(again, (out, lse, dk, dv, dq))),
                  f"flash {tag}: a repeat is not bit-identical")
        check(out.dtype == dtype and bool(torch.isfinite(out).all()),
              f"flash fwd {tag}: non-finite output or wrong dtype")
        check(float(out[0].abs().max()) == 0.0 and
              float(rl[0].max()) <= -1e29 and float(lse[0].max()) <= -1e29,
              f"flash fwd {tag}: the fully padded row is not O=0, LSE=-1e30")
        for g_ in (dq, dk, dv):
            check(float(g_[0].abs().max()) == 0.0,
                  f"flash bwd {tag}: the fully padded row has gradient")
        live = rl > -1e29
        lse_err = float((lse - rl)[live].abs().max())
        check(lse_err <= FLASH_TOL, f"flash fwd {tag}: LSE err {lse_err}")
        pairs = {"fwd": [(out, ro)], "dkv": [(dk, rk), (dv, rv)],
                 "dq": [(dq, rq)]}
        for name, ps in pairs.items():
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in ps)
            if dtype == torch.float32:
                tol = FLASH_TOL if name == "fwd" else FLASH_BWD_TOL
                check(err <= tol, f"flash {name} {tag}: max abs err {err} "
                      f"> {tol}")
            else:
                exc = max(bf16_excess(a, b) for a, b in ps)
                check(exc <= FLASH_BF16_ABS, f"flash {name} {tag}: exceeds "
                      f"one bf16 rounding step by {exc}")
            errs[name].append({"dtype": str(dtype), "causal": causal,
                               "shape": list(shape), "max_abs_err": err})
            log(f"flash {name} {tag}: max_abs_err={err:.3e}")
    return errs


def flash_timing(dev, shape=BERT_ATTN, dtype=torch.bfloat16, ragged=False):
    """Time the three kernels at a main path's inputs (bf16, all keys
    kept; BERT-base's by default, ERNIE-1.5B's ``ERNIE_ATTN``; the
    fine-tuning path's f32 ``FT_ATTN`` with ragged padding), over 4 input
    sets in turn so no call finds its inputs in L2."""
    from paddle1_tpu_torch.ops import flash_attention as fa
    from paddle1_tpu_torch.ops import flash_attention_bwd as fb
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sets, keep_ragged, keep = flash_case(dev, dtype, SEED + 4, n_sets=4,
                                         shape=shape)
    if ragged:
        keep = keep_ragged
    scale = 1.0 / shape[-1] ** 0.5
    fwd = [fa.flash_fwd(q, k, v, scale, False, keep) for q, k, v, _ in sets]
    deltas = [(do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
              for (_, _, _, do), (o, _) in zip(sets, fwd)]
    t = {}
    t["fwd"] = graph_time_ms([lambda s=s: fa.flash_fwd(
        s[0], s[1], s[2], scale, False, keep) for s in sets])
    t["fwd_plain"] = graph_time_ms([lambda s=s: fa.flash_attention_ref(
        s[0], s[1], s[2], scale, False, keep) for s in sets])
    t["dkv"] = graph_time_ms([lambda s=s, f=f, dl=dl: fb.flash_bwd_dkv(
        s[0], s[1], s[2], s[3], f[1], dl, scale, False, keep)
        for s, f, dl in zip(sets, fwd, deltas)])
    t["dq"] = graph_time_ms([lambda s=s, f=f, dl=dl: fb.flash_bwd_dq(
        s[0], s[1], s[2], s[3], f[1], dl, scale, False, keep)
        for s, f, dl in zip(sets, fwd, deltas)])
    t["bwd_plain"] = graph_time_ms([lambda s=s, f=f: fa.flash_bwd_ref(
        s[0], s[1], s[2], f[0], f[1], s[3], scale, False, keep)
        for s, f in zip(sets, fwd)])
    # the library: [B, H, N, D] copies, the same keep-mask
    lib = [[x.transpose(1, 2).contiguous() for x in s] for s in sets]
    m4 = keep[:, None, None, :]
    t["fwd_library"] = graph_time_ms([lambda s=s: sdpa(
        s[0], s[1], s[2], attn_mask=m4) for s in lib])
    leaves = [[x.clone().requires_grad_() for x in s[:3]] for s in lib]
    turn = [0]

    def lib_fwd_bwd(i=None):
        if i is None:
            i = turn[0] = (turn[0] + 1) % len(lib)
        q, k, v = leaves[i]
        out = sdpa(q, k, v, attn_mask=m4)
        torch.autograd.grad(out, (q, k, v), lib[i][3])
    t["fwd_bwd_library_eager"] = event_time_ms(lib_fwd_bwd)
    # the library's backward alone: forward + backward captured in a graph
    # and replayed, less the graph-replayed forward
    t["fwd_bwd_library"] = graph_time_ms([lambda i=i: lib_fwd_bwd(i)
                                          for i in range(len(lib))])
    t["bwd_library"] = t["fwd_bwd_library"] - t["fwd_library"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        lib_fwd_bwd(0)
    t["library_backend"] = sorted({e.name for e in prof.events()
                                   if "_attention" in e.name and
                                   e.name.startswith("aten::_")})
    bounds = flash_bounds(sets[0][0], keep)
    tag = str(dtype).split(".")[-1]
    log(f"flash timing ({tag} {list(sets[0][0].shape)}): fwd {t['fwd']:.5f} "
        f"ms (plain {t['fwd_plain']:.5f}, library {t['fwd_library']:.5f}, "
        f"bound {bounds['fwd'][0]:.5f}); dkv {t['dkv']:.5f} ms, dq "
        f"{t['dq']:.5f} ms (plain backward {t['bwd_plain']:.5f}, library "
        f"backward {t['bwd_library']:.5f} by graph replay, fwd+bwd "
        f"{t['fwd_bwd_library']:.5f} replayed, "
        f"{t['fwd_bwd_library_eager']:.5f} eager; library ops "
        f"{t['library_backend']}; bounds {bounds['dkv'][0]:.5f}, "
        f"{bounds['dq'][0]:.5f})")
    return t, bounds, [list(sets[0][0].shape), tag,
                       "ragged padding" if ragged else "all keys kept"]


def bert_shapes(h=BERT_HIDDEN, f=3072, v=BERT_VOCAB, layers=BERT_LAYERS,
                pos=512):
    """A BERT's parameter shapes as ``BertForPretraining.parameters()``
    lists them (the tied decoder weight once): BERT-base's by default."""
    emb = [(v, h), (pos, h), (2, h), (h,), (h,)]
    layer = [(h, h), (h,)] * 4 + [(h, f), (f,), (f, h), (h,)] + [(h,)] * 4
    heads = [(h, h), (h,), (h, h), (h,), (h,), (h,), (v,), (h, 2), (2,)]
    return emb + layer * layers + heads


def ernie_shapes():
    """ERNIE-1.5B's 398 parameter shapes (1,637,101,122 elements)."""
    return bert_shapes(ERNIE_HIDDEN, ERNIE_FFN, ERNIE_VOCAB, ERNIE_LAYERS,
                       ERNIE_POS)


def alternating_ms(fns, rounds=5, reps=20):
    """Each call's mean device time over ``rounds`` rounds that alternate
    the calls (in order, then reversed), every call timed the same way:
    captured into a CUDA graph and replayed ``reps`` times between CUDA
    events (:func:`graph_time_ms`). Returns ``{name: {"median_ms",
    "spread_ms" (max - min), "rounds_ms"}}``."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(graph_time_ms([fns[k]], reps))
    return {k: {"median_ms": float(np.median(v)),
                "spread_ms": max(v) - min(v), "rounds_ms": v}
            for k, v in times.items()}


def adam_tensors(shapes, dtype, g, dev, unaligned=False):
    """p, g (``dtype``), m1, m2 (f32) for ``shapes``. ``unaligned``: each
    tensor a view at an odd element offset into a larger buffer: the same
    offset for all four on even-indexed tensors (the kernel's scalar head,
    then 16-byte vectors), a different one each on odd-indexed tensors
    (no common alignment: all scalar)."""
    out = ([], [], [], [])
    for i, s in enumerate(shapes):
        n = int(np.prod(s))
        offs = ((i % 7 + 1,) * 4 if i % 2 == 0 else (1, 2, 3, 5)) \
            if unaligned else (0,) * 4
        for j, (lst, off) in enumerate(zip(out, offs)):
            k = n + off
            t = (torch.randn(k, device=dev, generator=g) if j < 3 else
                 torch.rand(k, device=dev, generator=g))
            t = t.to(dtype) if j < 2 else t * 0.01
            lst.append(t[off:].view(s))
    return out


def adam_check(fad, ts, sc, decs, scales, tag):
    """Run the kernel once over ``ts`` = (p, g, m1, m2) and hold every
    output to the plain version; returns the max abs error."""
    ps, gs, m1, m2 = ts
    b1, b2, eps = 0.9, 0.999, 1e-8
    want = [fad.fused_adam_ref(p, q, a, b, sc[0], sc[1], sc[2], d, b1, b2,
                               eps, 1.0 if scales is None else scales[i])
            for i, (p, q, a, b, d) in enumerate(zip(ps, gs, m1, m2, decs))]
    fad.fused_adam_(ps, gs, m1, m2, sc, decs, b1, b2, eps, scales)
    torch.cuda.synchronize()
    err = 0.0
    for got, w in zip(zip(ps, m1, m2), want):
        for a, b in zip(got, w):
            a, b = a.float(), b.float()
            err = max(err, float((a - b).abs().max()))
            check(bool(torch.isclose(a, b, rtol=ADAM_RTOL,
                                     atol=ADAM_ATOL).all()),
                  f"fused_adam {tag}: outside rtol {ADAM_RTOL} atol "
                  f"{ADAM_ATOL} of the plain version")
    log(f"fused_adam {tag}: max_abs_err={err:.3e}")
    return err


def adam_phase(dev):
    """Hold the fused AdamW kernel to its plain version over BERT-base's
    parameter list (f32 masters, as the main path; bf16 params too; with
    mixed per-tensor scales; on views at odd offsets) and time it against
    the plain per-tensor update and the library's fused AdamW
    (``capturable=True``): kernel and library in five alternating rounds
    of CUDA-graph replays (:func:`alternating_ms`), in f32 and in bf16."""
    from paddle1_tpu_torch.ops import fused_adam as fad
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    shapes = bert_shapes()
    n_el = sum(int(np.prod(s)) for s in shapes)
    sc = torch.tensor([LR, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    decays = [0.01] * len(shapes)
    b1, b2, eps = 0.9, 0.999, 1e-8

    # per-tensor learning-rate scales (ParamAttr(learning_rate=...)),
    # 0 included, and decays mixed with the filter's 0
    mixed = [ADAM_SCALES[i % len(ADAM_SCALES)] for i in range(len(shapes))]
    mixed_dec = [(0.01, 0.0)[i % 2] for i in range(len(shapes))]
    errs = []
    for dtype, scales, decs, unaligned in (
            (torch.float32, None, decays, False),
            (torch.bfloat16, None, decays, False),
            (torch.float32, mixed, mixed_dec, False),
            (torch.bfloat16, mixed, mixed_dec, False),
            (torch.float32, mixed, mixed_dec, True),
            (torch.bfloat16, mixed, mixed_dec, True)):
        ts = adam_tensors(shapes, dtype, g, dev, unaligned)
        tag = (f"{dtype} over {len(shapes)} tensors ({n_el} elements), lr "
               f"scales {sorted(set(scales or [1.0]))}"
               f"{', views at odd offsets' if unaligned else ''}")
        err = adam_check(fad, ts, sc, decs, scales, tag)
        errs.append({"dtype": str(dtype), "max_abs_err": err,
                     "lr_scales": sorted(set(scales or [1.0])),
                     "unaligned_views": unaligned})
        del ts

    out = {"cases": errs, "tensors": len(shapes), "elements": n_el}
    for dtype in (torch.float32, torch.bfloat16):
        ps, gs, m1, m2 = adam_tensors(shapes, dtype, g, dev)
        lib_ps = [torch.nn.Parameter(p.detach().clone()) for p in ps]
        for p, q in zip(lib_ps, gs):
            p.grad = q
        lib_opt = torch.optim.AdamW(lib_ps, lr=LR, weight_decay=0.01,
                                    fused=True, capturable=True)
        fns = {"kernel": lambda: fad.fused_adam_(ps, gs, m1, m2, sc, decays,
                                                 b1, b2, eps),
               "library": lib_opt.step}
        if dtype == torch.float32:
            fns["kernel_mixed_lr_scales"] = lambda: fad.fused_adam_(
                ps, gs, m1, m2, sc, mixed_dec, b1, b2, eps, mixed)
        t = alternating_ms(fns)
        item = ps[0].element_size()
        # p, g, m1, m2 in; p, m1, m2 out
        b_ms, by = bound((3 * item + 16.0) * n_el, 12.0 * n_el,
                         F32_FLOPS_PER_S)
        name = "f32" if dtype == torch.float32 else "bf16"
        out[name] = {"ms": t["kernel"]["median_ms"],
                     "ms_spread": t["kernel"]["spread_ms"],
                     "library_ms": t["library"]["median_ms"],
                     "library_ms_spread": t["library"]["spread_ms"],
                     "library_bytes_per_element": 7 * item,
                     "bound_ms": b_ms, "bound_by": by, "rounds_ms": {
                         k: v["rounds_ms"] for k, v in t.items()}}
        if dtype == torch.float32:
            out["ms_mixed_lr_scales"] = \
                t["kernel_mixed_lr_scales"]["median_ms"]

            def plain():
                for p, q, a, b in zip(ps, gs, m1, m2):
                    np_, na, nb = fad.fused_adam_ref(
                        p, q, a, b, sc[0], sc[1], sc[2], 0.01, b1, b2, eps)
                    p.copy_(np_)
                    a.copy_(na)
                    b.copy_(nb)
            out["plain_ms"] = graph_time_ms([plain], reps=5)
        log(f"fused_adam timing ({name}, {n_el} elements, 1 launch; "
            f"alternating rounds of graph replays): {out[name]['ms']:.5f} ms "
            f"(spread {out[name]['ms_spread']:.5f}; library "
            f"{out[name]['library_ms']:.5f}, spread "
            f"{out[name]['library_ms_spread']:.5f}; bound {b_ms:.5f} {by})")
        del ps, gs, m1, m2, lib_ps, lib_opt, fns
        torch.cuda.empty_cache()
    f32 = out["f32"]
    out.update(ms=f32["ms"], library_ms=f32["library_ms"],
               bound_ms=f32["bound_ms"], bound_by=f32["bound_by"])
    log(f"fused_adam f32: mixed lr scales {out['ms_mixed_lr_scales']:.5f} "
        f"ms, plain {out['plain_ms']:.5f} ms")
    return out


def train_layer_norm_case(dev, rows=BATCH * SEQ, h=BERT_HIDDEN,
                          dtype=torch.bfloat16):
    """The LayerNorm kernel at a training path's shape: BERT-base's bf16
    ``[BATCH * SEQ, 768]`` by default; ERNIE-1.5B's ``[2048, 2304]``
    (past the warp-per-row widths: the block-per-row kernel) in bf16 and
    f32. f32 is held to LN_TOL, bf16 to one rounding step."""
    from paddle1_tpu_torch.ops import layer_norm as ln
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    xs = [torch.randn(rows, h, device=dev, generator=g).to(dtype)
          for _ in range(4)]
    w_ = torch.randn(h, device=dev, generator=g).to(dtype)
    b_ = torch.randn(h, device=dev, generator=g).to(dtype)
    got, want = ln.fused_layer_norm(xs[0], w_, b_), ln.layer_norm_ref(
        xs[0], w_, b_)
    torch.cuda.synchronize()
    tag = f"layer_norm {str(dtype).split('.')[-1]} [{rows}, {h}]"
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        check(err <= LN_TOL, f"{tag}: max abs err {err} > {LN_TOL}")
    else:
        exc = bf16_excess(got, want)
        check(exc <= BF16_ABS, f"{tag}: exceeds one bf16 rounding step by "
              f"{exc}")
    again = ln.fused_layer_norm(xs[0], w_, b_)
    check(torch.equal(again, got), f"{tag}: a repeat is not bit-identical")
    ms = graph_time_ms([lambda x=x: ln.fused_layer_norm(x, w_, b_)
                        for x in xs])
    plain = graph_time_ms([lambda x=x: ln.layer_norm_ref(x, w_, b_)
                           for x in xs])
    lib = graph_time_ms([lambda x=x: torch.nn.functional.layer_norm(
        x, (h,), w_, b_, 1e-5) for x in xs])
    el = xs[0].element_size()
    b_ms, by = bound(2 * rows * h * el + 2 * h * el, 8.0 * rows * h,
                     F32_FLOPS_PER_S)
    log(f"{tag}: max_abs_err={err:.3e} kernel={ms:.5f}ms plain={plain:.5f}ms "
        f"library={lib:.5f}ms bound={b_ms:.5f}ms ({by})")
    return dict(shape=f"x[{rows}, {h}] {str(dtype).split('.')[-1]}",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=lib)


# ---------------------------------------------------------------------------
# phase 6: BERT-base pretraining (the second main path)


def train_counters():
    from paddle1_tpu_torch.ops import flash_attention as fa
    from paddle1_tpu_torch.ops import flash_attention_bwd as fb
    from paddle1_tpu_torch.ops import fused_adam as fad
    from paddle1_tpu_torch.ops import layer_norm as ln
    return {"flash_attention": fa.flash_fwd,
            "flash_attention_bwd_dkv": fb.flash_bwd_dkv,
            "flash_attention_bwd_dq": fb.flash_bwd_dq,
            "fused_adam": fad.fused_adam_,
            "layer_norm": ln.fused_layer_norm}


def bert_loss_fn(crit):
    def loss_fn(m, b):
        scores, rel = m(b["ids"])
        return crit(scores, rel, b["mlm"], b["nsp"])
    return loss_fn


def timed_steps(step_fn, n_steps):
    """bench.py's slope+readback protocol (bench.py:105-138): wall-time
    windows of lo and n_steps chained steps, each ending in a readback of
    the loss, three trials; the slope (T_hi - T_lo) / (n_steps - lo) is
    the per-step time with the readback's fixed cost cancelled."""
    lo = max(1, n_steps // 4)
    slopes, out, steps = [], None, 0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(lo):
            out = step_fn()
        float(out)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_steps):
            out = step_fn()
        float(out)
        t_hi = time.perf_counter() - t0
        steps += lo + n_steps
        if t_hi > t_lo:
            slopes.append((t_hi - t_lo) / (n_steps - lo))
    check(slopes, "slope timing rejected every trial")
    return slopes, out, steps


def train_phase(dev):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import (BertForPretraining,
                                               BertPretrainingCriterion,
                                               bert_base)
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    model = BertForPretraining(bert_base(hidden_dropout_prob=0.0,
                                         attention_probs_dropout_prob=0.0,
                                         generator=gen), generator=gen)
    check(all(p.device.type == "cuda" for p in model.parameters()),
          "BertForPretraining did not default to the card")
    crit = BertPretrainingCriterion(model.bert.vocab_size)
    eng = ParallelEngine(model, AdamW(learning_rate=LR,
                                      parameters=model.parameters()),
                         bert_loss_fn(crit), amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    v = model.bert.vocab_size
    batch = {"ids": rng.integers(1, v, (BATCH, SEQ)).astype(np.int32),
             "mlm": rng.integers(0, v, (BATCH, SEQ)).astype(np.int32),
             "nsp": rng.integers(0, 2, (BATCH,)).astype(np.int32)}
    torch.cuda.reset_peak_memory_stats()
    loss0 = float(eng.step(batch))          # warm-up: builds, allocates
    setup_s = time.perf_counter() - t0
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    slopes, last, steps = timed_steps(lambda: eng.step(batch), 8)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    loss_end = float(last)
    check(np.isfinite(loss0) and np.isfinite(loss_end),
          f"non-finite loss {loss0} / {loss_end}")
    check(loss_end < loss0, f"loss did not fall: {loss0} -> {loss_end}")
    want = {"flash_attention": BERT_LAYERS * steps,
            "flash_attention_bwd_dkv": BERT_LAYERS * steps,
            "flash_attention_bwd_dq": BERT_LAYERS * steps,
            "fused_adam": steps, "layer_norm": (2 * BERT_LAYERS + 2) * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times in "
              f"{steps} steps, want {n}")
    dt = float(np.median(slopes))
    n_params = sum(p.nelement() for p in model.parameters())
    emb = model.bert.embeddings
    lookup_only = (emb.position_embeddings.weight.nelement() +
                   emb.token_type_embeddings.weight.nelement())
    flops = (6 * (n_params - lookup_only) * BATCH * SEQ +
             12 * BERT_LAYERS * BATCH * SEQ * SEQ * BERT_HIDDEN)
    summary = {
        "train": "bert_base_pretraining", "amp": "bfloat16",
        "batch": BATCH, "seq_len": SEQ, "params": n_params,
        "setup_s": setup_s, "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3,
        "samples_per_s": BATCH / dt, "flops_per_step": flops,
        "mfu": flops / dt / BF16_FLOPS_PER_S,
        "loss_first": loss0, "loss_last": loss_end,
        "dispatches": eng.dispatch_count,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
    }
    log(json.dumps(summary))
    del eng, model
    return summary


def train_reference_check(dev):
    """BERT at full width, depth 2, f32: REF_STEPS steps on the kernel path
    against REF_STEPS on the plain path (every kernel flag ``never``) from
    identical weights, on a batch with ragged padded tails."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import (BertForPretraining,
                                               BertModel,
                                               BertPretrainingCriterion)
    gen = torch.Generator().manual_seed(SEED + 7)
    m_kernel = BertForPretraining(BertModel(
        num_hidden_layers=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, generator=gen), generator=gen)
    m_plain = copy.deepcopy(m_kernel)
    check(m_plain.cls.decoder_weight is
          m_plain.bert.embeddings.word_embeddings.weight,
          "deepcopy untied the decoder weight")
    crit = BertPretrainingCriterion(BERT_VOCAB)
    rng = np.random.default_rng(SEED + 7)
    b = 16
    ids = rng.integers(1, BERT_VOCAB, (b, SEQ)).astype(np.int32)
    lens = rng.integers(40, SEQ + 1, b)
    ids[np.arange(SEQ)[None, :] >= lens[:, None]] = 0
    mlm = rng.integers(0, BERT_VOCAB, (b, SEQ)).astype(np.int32)
    mlm[ids == 0] = -1
    batch = {"ids": ids, "mlm": mlm,
             "nsp": rng.integers(0, 2, (b,)).astype(np.int32)}
    counters = train_counters()

    def run(model):
        eng = ParallelEngine(model, AdamW(learning_rate=LR,
                                          parameters=model.parameters()),
                             bert_loss_fn(crit))
        return [float(eng.step(batch)) for _ in range(REF_STEPS)]
    before = {k: fn.launches for k, fn in counters.items()}
    lk = run(m_kernel)
    mid = {k: fn.launches for k, fn in counters.items()}
    with flags_guard(flash_attention="never", flash_backward="never",
                     fused_adam="never", fused_layer_norm="never"):
        lp = run(m_plain)
    after = {k: fn.launches for k, fn in counters.items()}
    check(all(mid[k] > before[k] for k in counters),
          "the kernel path skipped a kernel")
    check(after == mid, "the plain path launched a kernel")
    loss_err = max(abs(a - c) for a, c in zip(lk, lp))
    check(loss_err <= REF_TOL, f"losses differ by {loss_err}: {lk} vs {lp}")
    sk, sp = m_kernel.state_dict(), m_plain.state_dict()
    param_err, key_bias_err = 0.0, 0.0
    for k in sk:
        e = float((sk[k] - sp[k]).abs().max())
        if k.endswith("k_proj.bias"):
            key_bias_err = max(key_bias_err, e)
        else:
            param_err = max(param_err, e)
    check(param_err <= REF_TOL, f"params differ by {param_err}")
    check(key_bias_err <= REF_STEPS * LR, f"key biases differ by "
          f"{key_bias_err} > {REF_STEPS * LR}")
    for k in counters:
        counters[k].launches = before[k]
    out = {"train_reference": {"depth": 2, "dtype": "float32", "batch": b,
                               "steps": REF_STEPS, "losses_kernel": lk,
                               "losses_plain": lp,
                               "max_loss_err": loss_err,
                               "max_param_err": param_err,
                               "max_key_bias_err": key_bias_err}}
    log(json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 8: the batch-norm kernels against their plain versions


def bn_counters():
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    return {"fused_bn_train": fbn.fused_bn_train,
            "fused_bn_norm": fbn.fused_bn_norm,
            "fused_bn_train_bwd": fbb.train_bwd,
            "fused_bn_norm_bwd": fbb.norm_bwd}


def bn_inputs(dev, rows, c, dtype, seed, n_sets=1):
    """``n_sets`` sets of (x, gamma, beta, residual, mean, var, dy) for one
    batch norm: x ~ 1.5 N(0, 1) + 0.3, statistics like a trained layer's."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    out = []
    for _ in range(n_sets):
        x = (rnd(rows, c) * 1.5 + 0.3).to(dtype)
        out.append((x, rnd(c).to(dtype), rnd(c).to(dtype),
                    rnd(rows, c).to(dtype), rnd(c) * 0.2,
                    rnd(c).abs() + 0.5, rnd(rows, c).to(dtype)))
    return out


def stat_excess(got, want, rows):
    """How far |got - want| exceeds the statistics' tolerance."""
    got, want = got.float(), want.float()
    tol = BN_STAT_RTOL * want.abs() + BN_STAT_FLOOR * rows ** 0.5
    return float(((got - want).abs() - tol).max())


def row_excess(got, want):
    """How far |got - want| exceeds BN_ABS (f32) or one bf16 rounding
    step plus BN_ABS (bf16)."""
    got_f, want_f = got.float(), want.float()
    rel = BF16_REL if got.dtype == torch.bfloat16 else 0.0
    return float(((got_f - want_f).abs() - rel * want_f.abs()).max()) \
        - BN_ABS


def bn_check(dev):
    """Every kernel of the family against its plain version at the four
    shapes, f32 and bf16, act x residual, the training forward, the
    training backward and the given-statistics forward also repeated bit
    for bit; returns the max abs errors."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    errs = {k: [] for k in bn_counters()}
    eps = 1e-5
    for rows, c in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            (x, g, b, res, m, v, dy), = bn_inputs(dev, rows, c, dtype,
                                                  SEED + rows + c)
            for act in ("identity", "relu"):
                for use_res in (False, True):
                    r = res if use_res else None
                    tag = (f"[{rows}, {c}] {str(dtype).split('.')[-1]} "
                           f"act={act} res={use_res}")
                    y, mean, var = fbn._train_fwd(x, g, b, r, eps, act)
                    ry, rm, rv = fbn.fused_bn_train_ref(x, g, b, eps, act,
                                                        r)
                    tb = fbb.train_bwd(x, g, mean, var, y, dy, eps, act,
                                       use_res)
                    rtb = fbb.train_bwd_ref(x, g, mean, var, y, dy, eps,
                                            act, use_res)
                    yn = fbn._norm_fwd(x, m, v, g, b, r, eps, act)
                    ryn = fbn.fused_bn_norm_ref(x, m, v, g, b, eps, act, r)
                    nb = fbb.norm_bwd(x, g, m, v, yn, dy, eps, act, use_res)
                    rnb = fbb.norm_bwd_ref(x, g, m, v, yn, dy, eps, act,
                                           use_res)
                    torch.cuda.synchronize()
                    checks = {
                        "fused_bn_train": ([(y, ry)], [(mean, rm),
                                                       (var, rv)]),
                        "fused_bn_norm": ([(yn, ryn)], []),
                        "fused_bn_train_bwd": (
                            [(tb[0], rtb[0])] + ([(tb[3], rtb[3])]
                                                 if use_res else []),
                            [(tb[1], rtb[1]), (tb[2], rtb[2])]),
                        "fused_bn_norm_bwd": (
                            [(nb[0], rnb[0])] + ([(nb[3], rnb[3])]
                                                 if use_res else []),
                            [(nb[1], rnb[1]), (nb[2], rnb[2])])}
                    for name, (rows_pairs, stat_pairs) in checks.items():
                        for a, w in rows_pairs:
                            check(a.dtype == dtype and
                                  bool(torch.isfinite(a).all()),
                                  f"{name} {tag}: non-finite output or "
                                  f"dtype {a.dtype}")
                        exc = max(row_excess(a, w) for a, w in rows_pairs)
                        check(exc <= 0.0, f"{name} {tag}: rows differ "
                              f"from the plain version by {exc} beyond "
                              "the tolerance")
                        for a, w in stat_pairs:
                            sx = stat_excess(a, w, rows)
                            check(sx <= 0.0, f"{name} {tag}: statistics "
                                  f"differ by {sx} beyond the tolerance")
                        err = max(float((a.float() - w.float()).abs().max())
                                  for a, w in rows_pairs + stat_pairs)
                        errs[name].append({"shape": [rows, c],
                                           "dtype": str(dtype), "act": act,
                                           "residual": use_res,
                                           "max_abs_err": err})
                    # deterministic reductions: a repeat is bit-identical
                    again = fbn._train_fwd(x, g, b, r, eps, act)
                    check(torch.equal(again[1], mean) and
                          torch.equal(again[2], var) and
                          torch.equal(again[0], y),
                          f"fused_bn_train {tag}: a repeat differs")
                    if act == "relu" and use_res:
                        # the cooperative launch inside a CUDA graph
                        graph_replay_equal(
                            lambda: fbn._train_fwd(x, g, b, r, eps, act),
                            (y, mean, var), f"fused_bn_train {tag}")
                    again = fbb.train_bwd(x, g, mean, var, y, dy, eps, act,
                                          use_res)
                    check(all(torch.equal(a, w) for a, w in zip(again, tb)),
                          f"fused_bn_train_bwd {tag}: a repeat differs")
                    check(torch.equal(fbn._norm_fwd(x, m, v, g, b, r, eps,
                                                    act), yn),
                          f"fused_bn_norm {tag}: a repeat differs")
            log(f"batch norm kernels [{rows}, {c}]: f32 and bf16 x act x "
                "residual within tolerance, repeats bit-identical")
            del x, g, b, res, m, v, dy
    return errs


def bn_bytes(kind, rows, c, itemsize, reread=None):
    """(compulsory bytes, bytes this design moves) of one call at the
    main path's case (identity, no residual): each input read once and
    each output written once, against the passes the kernels make.
    ``reread``: the rows of x (and dy) a cooperative training kernel reads
    twice (those its plan keeps out of shared memory); None for a tree
    whose kernel reads all of them twice."""
    n = rows * c * itemsize
    ch = c * itemsize * 2 + c * 4 * 2     # gamma, beta; f32 mean/var
    tensors = 2 if kind == "fused_bn_train_bwd" else 1    # x (and dy)
    again = tensors * (n if reread is None else reread * c * itemsize)
    return {"fused_bn_train": (2 * n + ch, 2 * n + ch + again),
            "fused_bn_norm": (2 * n + ch, 2 * n + ch),
            "fused_bn_train_bwd": (3 * n + ch, 3 * n + ch + again),
            "fused_bn_norm_bwd": (3 * n + ch, 3 * n + ch)}[kind]


def bn_reread_rows(rows, c):
    """``{kind: (rows, plan)}`` of the cooperative training kernels (the
    forward and the backward) at ``[rows, C]`` in bf16 on this card: the
    rows their plans leave out of shared memory (read again in the last
    phase) and the plans; a kernel whose module has no plan (an older
    tree) is left out."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    x = torch.empty(rows, c, dtype=torch.bfloat16, device="cuda")
    out = {}
    for kind, plan in (("fused_bn_train",
                        getattr(fbn, "train_fwd_launch_plan", None)),
                       ("fused_bn_train_bwd",
                        getattr(fbb, "train_bwd_launch_plan", None))):
        if plan is None:
            continue
        p = plan(x, 1)
        held = sum(min(p.resident, rows - k * p.rows_per_chunk)
                   for k in range(p.chunks))
        out[kind] = (rows - held, p._asdict())
    return out


BN_FLOPS = {"fused_bn_train": 7.0, "fused_bn_norm": 4.0,
            "fused_bn_train_bwd": 10.0, "fused_bn_norm_bwd": 7.0}


def bn_timing(dev):
    """Time the four kernels at BN_SHAPES in bf16 (identity, no
    residual: every batch norm of the main path), over 4 input sets in
    turn, beside their plain versions, F.batch_norm on the same data as
    a channels-last [N, C, H, W] tensor, and their bounds; the bytes the
    design moves from the cooperative kernels' plans (their resident
    rows), where the imported tree has them."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    tbf = torch.nn.functional.batch_norm
    out = {k: [] for k in bn_counters()}
    eps = 1e-5
    for rows, c in BN_SHAPES:
        plans = bn_reread_rows(rows, c)
        sets = bn_inputs(dev, rows, c, torch.bfloat16, SEED + 9, n_sets=4)
        fwd = [fbn._train_fwd(s[0], s[1], s[2], None, eps, "identity")
               for s in sets]
        t = {}
        t["fused_bn_train"] = graph_time_ms([lambda s=s: fbn._train_fwd(
            s[0], s[1], s[2], None, eps, "identity") for s in sets])
        t["fused_bn_train_plain"] = graph_time_ms([
            lambda s=s: fbn.fused_bn_train_ref(s[0], s[1], s[2], eps)
            for s in sets])
        t["fused_bn_norm"] = graph_time_ms([lambda s=s: fbn._norm_fwd(
            s[0], s[4], s[5], s[1], s[2], None, eps, "identity")
            for s in sets])
        t["fused_bn_norm_plain"] = graph_time_ms([
            lambda s=s: fbn.fused_bn_norm_ref(s[0], s[4], s[5], s[1], s[2],
                                              eps) for s in sets])
        t["fused_bn_train_bwd"] = graph_time_ms([
            lambda s=s, f=f: fbb.train_bwd(s[0], s[1], f[1], f[2], None,
                                           s[6], eps, "identity")
            for s, f in zip(sets, fwd)])
        t["fused_bn_train_bwd_plain"] = graph_time_ms([
            lambda s=s, f=f: fbb.train_bwd_ref(s[0], s[1], f[1], f[2], None,
                                               s[6], eps, "identity")
            for s, f in zip(sets, fwd)])
        t["fused_bn_norm_bwd"] = graph_time_ms([
            lambda s=s: fbb.norm_bwd(s[0], s[1], s[4], s[5], None, s[6],
                                     eps, "identity") for s in sets])
        t["fused_bn_norm_bwd_plain"] = graph_time_ms([
            lambda s=s: fbb.norm_bwd_ref(s[0], s[1], s[4], s[5], None, s[6],
                                         eps, "identity") for s in sets])
        # the library: the same rows as [N, C, H, W] channels-last (N = 32
        # images, H = W), f32 affine and running statistics
        hw = rows // RN_BATCH
        side = int(round(hw ** 0.5))
        check(side * side * RN_BATCH == rows, f"{rows} rows are not "
              f"{RN_BATCH} square images")
        lib = [(s[0].view(RN_BATCH, side, side, c).permute(0, 3, 1, 2),
                s[1].float(), s[2].float(), s[4].clone(), s[5].clone(),
                s[6].view(RN_BATCH, side, side, c).permute(0, 3, 1, 2))
               for s in sets]
        check(lib[0][0].is_contiguous(memory_format=torch.channels_last),
              "library input is not channels-last")
        t["library_train_fwd"] = graph_time_ms([
            lambda s=s: tbf(s[0], s[3], s[4], s[1], s[2], True, 0.1, eps)
            for s in lib])
        t["library_eval_fwd"] = graph_time_ms([
            lambda s=s: tbf(s[0], s[3], s[4], s[1], s[2], False, 0.1, eps)
            for s in lib])
        # the library's backward alone: the op F.batch_norm's autograd
        # calls (_batch_norm_impl_index_backward, which dispatches to the
        # backend the forward chose: 0 native, 1 cuDNN) on the saved
        # outputs of its forward, checked against autograd once
        aten = torch.ops.aten
        backend = {}
        for mode, training in (("train", True), ("eval", False)):
            saved = [aten._batch_norm_impl_index(
                s[0], s[1], s[2], s[3].clone(), s[4].clone(), training, 0.1,
                eps, True) for s in lib]
            bwd = [lambda s=s, f=f: aten._batch_norm_impl_index_backward(
                f[4], s[0], s[5], s[1], s[3], s[4], f[1], f[2], training,
                eps, [True, True, True], f[3]) for s, f in zip(lib, saved)]
            xl, gl, bl = (v.detach().clone().requires_grad_()
                          for v in lib[0][:3])
            want = torch.autograd.grad(
                tbf(xl, lib[0][3].clone(), lib[0][4].clone(), gl, bl,
                    training, 0.1, eps), (xl, gl, bl), lib[0][5])
            got = bwd[0]()
            for a, w in zip(got, want):
                check(torch.allclose(a.float(), w.float(), rtol=1e-2,
                                     atol=1e-2),
                      f"the library's {mode} backward differs from "
                      "F.batch_norm's autograd")
            backend[mode] = {0: "native", 1: "cuDNN"}.get(saved[0][4],
                                                          str(saved[0][4]))
            t[f"library_{mode}_bwd"] = graph_time_ms(bwd)
            del saved, bwd, got, want, xl, gl, bl
        lib_for = {"fused_bn_train": ("library_train_fwd", "F.batch_norm "
                                      "training forward"),
                   "fused_bn_norm": ("library_eval_fwd", "F.batch_norm "
                                     "eval forward"),
                   "fused_bn_train_bwd": ("library_train_bwd",
                                          "F.batch_norm's training backward"
                                          f" alone ({backend['train']})"),
                   "fused_bn_norm_bwd": ("library_eval_bwd",
                                         "F.batch_norm's eval backward "
                                         f"alone ({backend['eval']})")}
        for name in out:
            reread, plan = plans.get(name, (None, None))
            need, moved = bn_bytes(name, rows, c, 2, reread)
            b_ms, by = bound(need, BN_FLOPS[name] * rows * c,
                             F32_FLOPS_PER_S)
            lk, cover = lib_for[name]
            out[name].append({
                "shape": [rows, c], "dtype": "bf16", "act": "identity",
                "residual": False, "ms": t[name],
                "plain_ms": t[name + "_plain"], "library_ms": t[lk],
                "library_covers": cover, "bound_ms": b_ms, "bound_by": by,
                "bound_bytes": need, "design_bytes": moved,
                "design_bytes_ms_at_peak": 1e3 * moved / HBM_BYTES_PER_S})
            if plan is not None:
                out[name][-1]["plan"] = plan
            log(f"{name} bf16 [{rows}, {c}]: kernel {t[name]:.5f} ms, plain "
                f"{t[name + '_plain']:.5f} ms, library ({cover}) "
                f"{t[lk]:.5f} ms, bound {b_ms:.5f} ms ({by}; the design "
                f"moves {moved / need:.2f}x the compulsory bytes)")
        del sets, fwd, lib
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: ResNet-50 training, eval and frozen-statistics fine-tuning


def rn_loss_fn(m, b):
    from paddle1_tpu_torch.nn import functional as F
    return F.cross_entropy(m(b["x"]), b["y"])


def bn_launches(counters):
    return {k: fn.launches for k, fn in counters.items()}


def zero(counters):
    for fn in counters.values():
        fn.launches = 0


def resnet_phase(dev):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.nn import BatchNorm2D
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet50
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    model = resnet50(generator=gen)
    check(all(t.device.type == "cuda" for t in model.state_dict().values()),
          "resnet50 did not default to the card")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2D)]
    check(len(bns) == RN_BNS, f"resnet50 has {len(bns)} batch norms")
    eng = ParallelEngine(model, Momentum(learning_rate=RN_LR, momentum=0.9,
                                         parameters=model.parameters()),
                         rn_loss_fn, amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    staged = [{"x": torch.from_numpy(rng.standard_normal(
                   (RN_BATCH, 3, RN_IMG, RN_IMG)).astype(np.float32)).to(dev),
               "y": torch.from_numpy(rng.integers(
                   0, 1000, (RN_BATCH,)).astype(np.int64)).to(dev)}
              for _ in range(2)]
    it = [0]

    def step():
        it[0] += 1
        return eng.step(staged[it[0] % 2])
    torch.cuda.reset_peak_memory_stats()
    first = [float(eng.step(staged[0])), float(eng.step(staged[1]))]
    setup_s = time.perf_counter() - t0
    counters = bn_counters()
    zero(counters)
    it[0] = 1
    slopes, _, steps = timed_steps(step, 10)
    torch.cuda.synchronize()
    train = bn_launches(counters)
    want = {"fused_bn_train": RN_BNS * steps, "fused_bn_norm": 0,
            "fused_bn_train_bwd": RN_BNS * steps, "fused_bn_norm_bwd": 0}
    check(train == want, f"training launches {train}, want {want} "
          f"({steps} steps)")
    last = [float(eng.step(staged[0])), float(eng.step(staged[1]))]
    check(all(np.isfinite(first + last)), f"non-finite loss {first} "
          f"{last}")
    check(sum(last) < sum(first), f"loss did not fall over the cycled "
          f"batches: {first} -> {last}")
    dt = float(np.median(slopes))
    peak = torch.cuda.max_memory_allocated() / 1e9

    model.eval()
    zero(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        logits = model(staged[0]["x"])
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t1) * 1e3
    evals = bn_launches(counters)
    want = {"fused_bn_train": 0, "fused_bn_norm": RN_BNS,
            "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": 0}
    check(evals == want, f"eval launches {evals}, want {want}")
    check(tuple(logits.shape) == (RN_BATCH, 1000) and
          bool(torch.isfinite(logits).all()), "eval logits not finite "
          f"[{RN_BATCH}, 1000]")

    model.train()
    for bn in bns:
        bn._use_global_stats = True
    before = {n: b.detach().clone() for n, b in model.named_buffers()}
    zero(counters)
    frozen_loss = float(eng.step(staged[0]))
    torch.cuda.synchronize()
    frozen = bn_launches(counters)
    want = {"fused_bn_train": 0, "fused_bn_norm": RN_BNS,
            "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": RN_BNS}
    check(frozen == want, f"frozen-statistics launches {frozen}, want "
          f"{want}")
    check(np.isfinite(frozen_loss), f"non-finite frozen loss {frozen_loss}")
    # no batch statistics were blended: the buffers move only by the
    # optimizer, as the JAX engine moves them (lr 1e-3: a small step)
    drift = max(float((b - before[n]).abs().max())
                for n, b in model.named_buffers())
    summary = {
        "train": "resnet50", "amp": "bfloat16", "batch": RN_BATCH,
        "img": RN_IMG, "params": sum(p.nelement() for p in model.parameters()),
        "batch_norms": RN_BNS, "setup_s": setup_s, "steps": steps,
        "timing": "slope+readback", "step_ms_median": dt * 1e3,
        "step_ms_min": min(slopes) * 1e3, "step_ms_max": max(slopes) * 1e3,
        "samples_per_s": RN_BATCH / dt,
        "flops_per_step": RN_FLOPS_PER_SAMPLE * RN_BATCH,
        "mfu": RN_FLOPS_PER_SAMPLE * RN_BATCH / dt / BF16_FLOPS_PER_S,
        "loss_first": first, "loss_last": last,
        "peak_mem_gb": peak, "launches_train": train,
        "launches_per_step": {k: n / steps for k, n in train.items()},
        "eval_ms_f32": eval_ms, "launches_eval": evals,
        "frozen_loss": frozen_loss, "launches_frozen": frozen,
        "frozen_buffer_max_move": drift,
    }
    log(json.dumps(summary))
    del eng, model, staged
    return summary


def rn_f64_loss_fn(m, b):
    # plain PyTorch float64 throughout, the loss included
    return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])


def rn_first_grads(model, batch, loss_fn):
    """Loss and float64 copies of every parameter's gradient of one
    eager training-mode forward and backward (the model's running
    statistics move: callers pass a copy)."""
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), [g.double() for g in grads]


def rn_grad_gaps(model, batch):
    """First-step gradients of ``model`` (f32) on the kernel path, on the
    plain path twice and in float64 (the plain path): per parameter
    ``|g_a - g_b| / |g_f64|``, the worst over the parameters of each
    pair, and that parameter's name."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    names = [n for n, _ in model.named_parameters()]
    runs = {"kernel": rn_first_grads(copy.deepcopy(model), batch,
                                     rn_loss_fn)}
    with flags_guard(fused_bn="never", fused_bn_bwd="never"):
        for k in ("plain", "plain_again"):
            runs[k] = rn_first_grads(copy.deepcopy(model), batch, rn_loss_fn)
        with flags_guard(conv_nhwc="never"):
            exact = {"x": batch["x"].double(), "y": batch["y"]}
            runs["f64"] = rn_first_grads(copy.deepcopy(model).double(),
                                         exact, rn_f64_loss_fn)
    ref = runs["f64"][1]
    gaps = {}
    for a, b in (("kernel", "plain"), ("kernel", "f64"), ("plain", "f64"),
                 ("plain", "plain_again")):
        rel = [float((ga - gb).norm() / gr.norm().clamp_min(1e-30))
               for ga, gb, gr in zip(runs[a][1], runs[b][1], ref)]
        i = int(np.argmax(rel))
        gaps[f"{a}_vs_{b}"] = {"max": rel[i], "param": names[i],
                               "median": float(np.median(rel))}
    return {"losses": {k: v[0] for k, v in runs.items()}, "gaps": gaps}


def rn_engine_steps(model, batch, steps):
    """``steps`` Momentum steps of ``model`` through ParallelEngine (f32,
    no amp); returns the losses."""
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import Momentum
    eng = ParallelEngine(model, Momentum(learning_rate=RN_LR, momentum=0.9,
                                         parameters=model.parameters()),
                         rn_loss_fn)
    return [float(eng.step(batch)) for _ in range(steps)]


def resnet_reference_readings(dev, batch, img, blocks=None, steps=0):
    """ResNet-50 at full width in f32 (``blocks``: the depth cut to the
    first blocks of each stage), batch ``batch`` x 3 x ``img`` x ``img``,
    seeded weights and data, cuDNN deterministic:

    * ``grads``: the first step's gradients on the kernel path, the plain
      path (``fused_bn``/``fused_bn_bwd`` never: the plain batch-norm arm),
      a repeat of the plain path and float64 (:func:`rn_grad_gaps`);
    * with ``steps``: that many Momentum steps on the kernel path and on
      the plain path from identical weights: the losses, and the largest
      differences of the parameters and of the running statistics after
      the last step, beside the largest move of a parameter;
    * the kernel launches of the kernel path's steps and the plain path's."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.vision.models import resnet50
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    counters = bn_counters()
    try:
        m_kernel = resnet50(device=dev,
                            generator=torch.Generator().manual_seed(SEED + 8))
        if blocks is not None:
            for i in range(1, 5):
                name = f"layer{i}"
                setattr(m_kernel, name, getattr(m_kernel, name)[:blocks])
        m_plain = copy.deepcopy(m_kernel)
        init = {k: v.detach().clone()
                for k, v in m_kernel.state_dict().items()}
        rng = np.random.default_rng(SEED + 8)
        data = {"x": torch.from_numpy(rng.standard_normal(
                    (batch, 3, img, img)).astype(np.float32)).to(dev),
                "y": torch.from_numpy(rng.integers(
                    0, 1000, (batch,))).to(dev)}
        out = {"dtype": "float32", "blocks_per_stage": blocks,
               "batch_norms": sum(k.endswith("._mean") for k in init),
               "batch": batch, "img": img, "steps": steps,
               "grads": rn_grad_gaps(m_kernel, data)}
        before = bn_launches(counters)
        out["losses_kernel"] = rn_engine_steps(m_kernel, data, steps)
        mid = bn_launches(counters)
        with flags_guard(fused_bn="never", fused_bn_bwd="never"):
            out["losses_plain"] = rn_engine_steps(m_plain, data, steps)
        after = bn_launches(counters)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    out["launches_kernel"] = {k: mid[k] - before[k] for k in mid}
    out["launches_plain"] = {k: after[k] - mid[k] for k in mid}
    if steps:
        sk, sp = m_kernel.state_dict(), m_plain.state_dict()
        stats = [k for k in sk if k.endswith(("_mean", "_variance"))]
        params = [k for k in sk if k not in stats]

        def max_diff(a, b, keys):
            return max(float((a[k].double() - b[k].double()).abs().max())
                       for k in keys)
        out.update(max_loss_err=max(abs(a - b) for a, b in zip(
                       out["losses_kernel"], out["losses_plain"])),
                   max_param_err=max_diff(sk, sp, params),
                   max_running_stat_err=max_diff(sk, sp, stats),
                   max_param_move=max_diff(sp, init, params))
    return out


def resnet_reference_check(dev):
    """The kernel path against the plain path in f32, in two parts.

    1. Full depth (53 batch norms), batch 8 x 224 x 224, the first step:
       the losses agree to REF_TOL, and the kernel path's gradients are
       no farther from float64 than RN_F64_FACTOR times the plain path's
       (worst parameter and median, each relative to the parameter's
       float64 gradient). At full depth from this random init the
       gradient is ill-conditioned: the plain path's own f32 gradients
       differ from float64 by percents (printed), so the two f32 paths
       cannot agree more closely than that, and steps taken on such
       gradients part further.
    2. Full width, depth cut to one bottleneck per stage (17 batch norms),
       batch 32 x 64 x 64, where f32 gradients are well-conditioned: each
       parameter's first-step gradient agrees to RN_GRAD_TOL of its
       float64 norm, and after REF_STEPS Momentum steps through
       ParallelEngine the losses, the parameters and the running
       statistics agree to REF_TOL."""
    full = resnet_reference_readings(dev, **RN_REF_FULL)
    cut = resnet_reference_readings(dev, steps=REF_STEPS, **RN_REF_CUT)
    log(json.dumps({"resnet_reference": {"full_depth": full,
                                         "depth_cut": cut}}))
    want = {"fused_bn_train": cut["batch_norms"] * REF_STEPS,
            "fused_bn_norm": 0,
            "fused_bn_train_bwd": cut["batch_norms"] * REF_STEPS,
            "fused_bn_norm_bwd": 0}
    check(cut["launches_kernel"] == want, f"the kernel path launched "
          f"{cut['launches_kernel']}, want {want}")
    for r in (full, cut):
        check(not any(r["launches_plain"].values()),
              f"the plain path launched {r['launches_plain']}")
        check(r["grads"]["gaps"]["plain_vs_plain_again"]["max"] == 0.0,
              "the plain path does not repeat bit for bit")
    losses = full["grads"]["losses"]
    check(abs(losses["kernel"] - losses["plain"]) <= REF_TOL,
          f"full depth: first losses differ: {losses}")
    gaps = full["grads"]["gaps"]
    for stat in ("max", "median"):
        k, p = gaps["kernel_vs_f64"][stat], gaps["plain_vs_f64"][stat]
        check(k <= RN_F64_FACTOR * p, f"full depth: the kernel path's "
              f"gradients are {k} ({stat}) from float64, the plain path's "
              f"{p}")
    gap = cut["grads"]["gaps"]["kernel_vs_plain"]
    check(gap["max"] <= RN_GRAD_TOL, f"depth cut: first-step gradients "
          f"differ by {gap['max']} of the float64 gradient at "
          f"{gap['param']} (> {RN_GRAD_TOL})")
    for key in ("max_loss_err", "max_param_err", "max_running_stat_err"):
        check(cut[key] <= REF_TOL, f"depth cut: {key} {cut[key]} > "
              f"{REF_TOL}")
    return full, cut


# ---------------------------------------------------------------------------
# phase 11: the local-moments kernel against its plain version


def moments_phase(dev):
    """The moments kernel against its plain version at the four shapes,
    f32 and bf16; then timed in bf16 over 4 input sets in turn beside its
    plain version, ``torch.batch_norm_stats`` on the same rows as a
    channels-last [N, C, H, W] tensor (its mean and invstd, checked
    against the kernel's sums) and its bound: one read of x, two f32 [C]
    written; 3 flops per element at the f32 rate."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    errs, times = [], []
    eps = 1e-5
    for rows, c in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = bn_inputs(dev, rows, c, dtype, SEED + 11 + rows + c)[0][0]
            s, ss = fbn._moments_fwd(x)
            rs, rss = fbn.local_moments_ref(x)
            torch.cuda.synchronize()
            tag = f"[{rows}, {c}] {str(dtype).split('.')[-1]}"
            for a, w in ((s, rs), (ss, rss)):
                check(a.dtype == torch.float32 and
                      bool(torch.isfinite(a).all()),
                      f"local_moments {tag}: non-finite or {a.dtype}")
                sx = stat_excess(a, w, rows)
                check(sx <= 0.0, f"local_moments {tag}: sums differ from "
                      f"the plain version by {sx} beyond the tolerance")
            again = fbn._moments_fwd(x)
            check(torch.equal(again[0], s) and torch.equal(again[1], ss),
                  f"local_moments {tag}: a repeat differs")
            # the training forward sums in the moments' chunks and order
            c1 = torch.ones(c, dtype=dtype, device=dev)
            mean = fbn._train_fwd(x, c1, c1, None, eps, "identity")[1]
            check(torch.equal(mean, s * torch.tensor(
                1.0 / rows, dtype=torch.float32)), f"local_moments {tag}: "
                "the training forward's mean is not the moments' sum x "
                "1 / rows bit for bit")
            errs.append({"shape": [rows, c], "dtype": str(dtype),
                         "max_abs_err": max(float((a - w).abs().max())
                                            for a, w in ((s, rs),
                                                         (ss, rss)))})
            del x, s, ss, rs, rss, again
        xs = [t[0] for t in bn_inputs(dev, rows, c, torch.bfloat16,
                                      SEED + 12, n_sets=4)]
        hw = rows // RN_BATCH
        side = int(round(hw ** 0.5))
        check(side * side * RN_BATCH == rows, f"{rows} rows are not "
              f"{RN_BATCH} square images")
        lib = [x.view(RN_BATCH, side, side, c).permute(0, 3, 1, 2)
               for x in xs]
        check(lib[0].is_contiguous(memory_format=torch.channels_last),
              "library input is not channels-last")
        mean, invstd = torch.batch_norm_stats(lib[0], eps)
        s, ss = fbn._moments_fwd(xs[0])
        var = ss / rows - (s / rows) ** 2
        check(torch.allclose(mean.float(), s / rows, rtol=1e-3, atol=1e-3)
              and torch.allclose(invstd.float(), torch.rsqrt(var + eps),
                                 rtol=1e-3, atol=1e-3),
              "torch.batch_norm_stats computes other moments")
        t = {"ms": graph_time_ms([lambda x=x: fbn._moments_fwd(x)
                                  for x in xs]),
             "plain_ms": graph_time_ms([lambda x=x: fbn.local_moments_ref(x)
                                        for x in xs]),
             "library_ms": graph_time_ms([
                 lambda x=x: torch.batch_norm_stats(x, eps) for x in lib])}
        need = rows * c * 2 + 2 * c * 4
        b_ms, by = bound(need, 3.0 * rows * c, F32_FLOPS_PER_S)
        times.append({"shape": [rows, c], "dtype": "bf16", **t,
                      "library_covers": "torch.batch_norm_stats (mean, "
                                        "invstd) on channels-last NCHW",
                      "bound_ms": b_ms, "bound_by": by,
                      "bound_bytes": need})
        log(f"local_moments bf16 [{rows}, {c}]: kernel {t['ms']:.5f} ms, "
            f"plain {t['plain_ms']:.5f} ms, torch.batch_norm_stats "
            f"{t['library_ms']:.5f} ms, bound {b_ms:.5f} ms ({by})")
        del xs, lib
        torch.cuda.empty_cache()
    dp_pattern_replay(dev)
    log("local_moments: f32 and bf16 within tolerance at "
        f"{[list(s) for s in BN_SHAPES]}, repeats bit-identical, the "
        "training forward's mean its sum / rows bit for bit")
    return errs, times


def dp_pattern_replay(dev):
    """53 calls alternating the moments and the given-statistics
    backward on one stream over the four shapes (their ticket counters
    shared, as in a dp step), replayed twice in one CUDA graph: each
    replay equal to the eager calls bit for bit."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    sets = [bn_inputs(dev, rows, c, torch.bfloat16, SEED + 13 + i)[0]
            for i, (rows, c) in enumerate(BN_SHAPES)]

    def run():
        out = []
        for i in range(RN_BNS):
            x, g, _, _, m, v, dy = sets[(i // 2) % len(sets)]
            out += fbn._moments_fwd(x) if i % 2 == 0 else fbb.norm_bwd(
                x, g, m, v, None, dy, 1e-5, "identity", True)
        return tuple(out)
    graph_replay_equal(run, run(), "moments / norm_bwd, 53 alternating")
    del sets
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: data-parallel ResNet-50 at world size 1 over NCCL


def dp_counters():
    from paddle1_tpu_torch.ops import fused_bn as fbn
    return {"fused_bn_moments": fbn.local_moments, **bn_counters()}


class AllReduceCount:
    """Counts ``torch.distributed.all_reduce`` calls inside the block (the
    port's collectives call it through the module)."""

    def __enter__(self):
        import torch.distributed as tdist
        self.n, self._orig = 0, tdist.all_reduce

        def counted(*a, **kw):
            self.n += 1
            return self._orig(*a, **kw)
        tdist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist
        tdist.all_reduce = self._orig
        return False


def device_kernels_per_step(step, n, top=12):
    """What the device ran per step over ``n`` steps under
    ``torch.profiler`` (CPU + CUDA activities): every device-side event
    but label spans (as ``tools/torch_train_profile.py`` counts them),
    their summed time, the wall ms a step of the profiled window (slowed
    by the profiler's host work: an idle share is read against an
    untraced step instead), the batch-norm kernels by name, and the
    ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step()
        float(loss)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    check(events, "the profiler saw no device work in the step")
    bn, kernels = {}, {}
    for e in events:
        for name in BN_KERNELS["fused_bn"] + BN_KERNELS["fused_bn_bwd"] + (
                "finalize_kernel",):
            if name in e.name:
                bn[name] = bn.get(name, 0) + 1
        us, k = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"kernels_per_step": len(events) / n,
            "device_busy_ms_per_step": sum(
                e.time_range.elapsed_us() for e in events) / 1e3 / n,
            "profiled_step_ms": wall_ms,
            "bn_kernels_per_step": {k: v / n for k, v in bn.items()},
            "top_kernels": [{"name": name[:100], "ms_per_step": us / 1e3 / n,
                             "calls_per_step": k / n}
                            for name, (us, k) in ranked[:top]]}


def resnet_dp_phase(dev, single):
    """``benches.py``'s dp configuration at world size 1 on NCCL: every
    batch norm on the cross-rank arm. ``single``: phase 9's summary."""
    from paddle1_tpu_torch import distributed as pdist
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet50
    t0 = time.perf_counter()
    pdist.init_parallel_env()
    try:
        backend = torch.distributed.get_backend()
        check(backend == "nccl", f"init_parallel_env chose {backend} on the "
              "card")
        model = resnet50(generator=torch.Generator().manual_seed(SEED))
        eng = pdist.ParallelEngine(
            model, Momentum(learning_rate=RN_LR, momentum=0.9,
                            parameters=model.parameters()),
            rn_loss_fn, mesh=pdist.build_mesh(dp=1), amp_dtype="bfloat16")
        rng = np.random.default_rng(0)
        staged = [eng.shard_batch({
            "x": torch.from_numpy(rng.standard_normal(
                (RN_BATCH, 3, RN_IMG, RN_IMG)).astype(np.float32)).to(dev),
            "y": torch.from_numpy(rng.integers(
                0, 1000, (RN_BATCH,)).astype(np.int64)).to(dev)})
            for _ in range(2)]
        it = [0]

        def step():
            it[0] += 1
            return eng.step(staged[it[0] % 2])
        first = [float(eng.step(staged[0])), float(eng.step(staged[1]))]
        setup_s = time.perf_counter() - t0
        counters = dp_counters()
        zero(counters)
        it[0] = 1
        with AllReduceCount() as calls:
            slopes, _, steps = timed_steps(step, 10)
            torch.cuda.synchronize()
        launches = bn_launches(counters)
        want = {"fused_bn_moments": RN_BNS * steps,
                "fused_bn_train": 0, "fused_bn_norm": RN_BNS * steps,
                "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": RN_BNS * steps}
        check(launches == want, f"dp launches {launches}, want {want} "
              f"({steps} steps)")
        check(calls.n == (2 * RN_BNS + 1) * steps, f"{calls.n} all-reduces "
              f"in {steps} steps, want {2 * RN_BNS + 1} per step")
        device = device_kernels_per_step(step, 2)
        for name in ("moments_kernel", "norm_bwd_kernel"):
            got = device["bn_kernels_per_step"].get(name, 0)
            check(got == RN_BNS, f"dp step: {got} {name} launches a step on "
                  f"the device, want {RN_BNS} (one CUDA launch a call)")
        last = [float(eng.step(staged[0])), float(eng.step(staged[1]))]
        check(all(np.isfinite(first + last)), f"non-finite dp loss {first} "
              f"{last}")
        check(sum(last) < sum(first), f"dp loss did not fall over the "
              f"cycled batches: {first} -> {last}")
    finally:
        pdist.destroy_process_group()
    dt = float(np.median(slopes))
    summary = {
        "train": "resnet50_dp", "backend": backend, "world_size": 1,
        "amp": "bfloat16", "batch_per_rank": RN_BATCH, "img": RN_IMG,
        "setup_s": setup_s, "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3, "samples_per_s": RN_BATCH / dt,
        "mfu": RN_FLOPS_PER_SAMPLE * RN_BATCH / dt / BF16_FLOPS_PER_S,
        "single_device_step_ms_median": single["step_ms_median"],
        "single_device_samples_per_s": single["samples_per_s"],
        "single_device_mfu": single["mfu"],
        "loss_first": first, "loss_last": last, "launches_train": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "all_reduces_per_step": calls.n / steps, **device}
    log(json.dumps(summary))
    del eng, model, staged
    return summary


# ---------------------------------------------------------------------------
# phase 13: two ranks against one


def rn_cut_setup(dev):
    """Phase 13's model and global batch: ResNet-50 at full width cut to
    RN_REF_CUT's blocks per stage, seeded weights and data, f32, cuDNN
    deterministic and no TF32."""
    from paddle1_tpu_torch.vision.models import resnet50
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = resnet50(device=dev,
                     generator=torch.Generator().manual_seed(SEED + 13))
    for i in range(1, 5):
        name = f"layer{i}"
        setattr(model, name, getattr(model, name)[:RN_REF_CUT["blocks"]])
    rng = np.random.default_rng(SEED + 13)
    n, img = RN_REF_CUT["batch"], RN_REF_CUT["img"]
    data = {"x": torch.from_numpy(rng.standard_normal(
                (n, 3, img, img)).astype(np.float32)).to(dev),
            "y": torch.from_numpy(rng.integers(0, 1000, (n,))).to(dev)}
    return model, data


def rn_dp_steps(model, data, mesh):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import Momentum
    eng = ParallelEngine(model, Momentum(learning_rate=RN_LR, momentum=0.9,
                                         parameters=model.parameters()),
                         rn_loss_fn, mesh=mesh)
    return [float(eng.step(data)) for _ in range(REF_STEPS)]


def rank_worker(out_dir, init_file, backend, one_card):
    """One rank of phase 13 (started by ``distributed.spawn``): join the
    job, take REF_STEPS steps on the global batch, save the losses, the
    state and the kernel launches."""
    import os
    from paddle1_tpu_torch import distributed as pdist
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    dev = torch.device("cuda", 0 if one_card else rank)
    pdist.init_parallel_env(backend=backend, device=dev,
                            init_method=f"file://{init_file}")
    try:
        model, data = rn_cut_setup(dev)
        counters = dp_counters()
        zero(counters)
        losses = rn_dp_steps(model, data,
                             pdist.build_mesh(dp=pdist.get_world_size()))
        torch.cuda.synchronize()
        torch.save({"losses": losses, "launches": bn_launches(counters),
                    "backend": torch.distributed.get_backend(),
                    "state": {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        pdist.destroy_process_group()


def cross_rank_check(dev, runs=None):
    """Ranks of the dp engine against the world-size-1 engine on the whole
    batch. ``runs``: ``(backend, one_card, ranks)`` triples; default
    DP_RANKS ranks over gloo on the one card, and over NCCL one rank per
    card where there are DP_RANKS cards."""
    import os
    import tempfile
    from paddle1_tpu_torch import distributed as pdist
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        model, data = rn_cut_setup(dev)
        n_bns = sum(k.endswith("._mean") for k in model.state_dict())
        ref_losses = rn_dp_steps(model, data, pdist.build_mesh(dp=1))
        ref = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    del model, data
    torch.cuda.empty_cache()
    if runs is None:
        runs = [("gloo", True, DP_RANKS)]
        if torch.cuda.device_count() >= DP_RANKS:
            runs.append(("nccl", False, DP_RANKS))
    out = {"global_batch": RN_REF_CUT["batch"], "img": RN_REF_CUT["img"],
           "batch_norms": n_bns, "steps": REF_STEPS,
           "losses_world_size_1": ref_losses}
    for backend, one_card, n_ranks in runs:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            pdist.spawn(rank_worker, args=(tmp, os.path.join(tmp, "store"),
                                           backend, one_card),
                        nprocs=n_ranks, timeout=DP_RANK_TIMEOUT_S)
            wall = time.perf_counter() - t0
            got = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                   for r in range(n_ranks)]
        stats = [k for k in ref if k.endswith(("_mean", "_variance"))]
        params = [k for k in ref if k not in stats]
        r0 = got[0]["state"]

        def max_diff(keys):
            return max(float((r0[k].double() - ref[k].double()).abs().max())
                       for k in keys)
        res = {"backend": got[0]["backend"], "ranks": n_ranks,
               "one_card": one_card, "wall_s": wall,
               "losses": got[0]["losses"],
               "max_loss_err": max(abs(a - b) for a, b in
                                   zip(got[0]["losses"], ref_losses)),
               "max_param_err": max_diff(params),
               "max_running_stat_err": max_diff(stats),
               "ranks_identical": all(
                   torch.equal(g["state"][k], r0[k])
                   for g in got[1:] for k in r0),
               "launches_rank0": got[0]["launches"]}
        out[f"{backend}_{n_ranks}_ranks"] = res
    if all(r[0] != "nccl" for r in runs):
        out["nccl"] = "skipped: one card (NCCL takes one card per rank)"
    log(json.dumps({"cross_rank_check": out}))
    want = n_bns * REF_STEPS
    for backend, _, n_ranks in runs:
        res = out[f"{backend}_{n_ranks}_ranks"]
        check(res["backend"] == backend, f"ranks ran {res['backend']}")
        check(res["ranks_identical"], f"{backend}: the ranks' parameters "
              "differ")
        check(res["launches_rank0"]["fused_bn_moments"] == want and
              res["launches_rank0"]["fused_bn_train"] == 0,
              f"{backend}: rank 0 launched {res['launches_rank0']}, want "
              f"{want} moments and no training-mode kernel")
        for key in ("max_loss_err", "max_param_err", "max_running_stat_err"):
            check(res[key] <= REF_TOL, f"{backend}: {n_ranks} ranks against "
                  f"world size 1: {key} {res[key]} > {REF_TOL}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the row-softmax kernel against its plain version


def softmax_phase(dev):
    """The softmax kernel against its plain version at SM_SHAPES, f32
    (SM_TOL abs), bf16 and f16 (one rounding step), repeats bit-identical,
    with
    a masked (-inf) half row; the gradient through its autograd Function
    against plain autograd in f32; then timed in bf16 over enough input
    sets to leave the L2 cache, beside its plain version, ``torch.softmax``
    (the library) and its bound: x read once and y written once,
    ``2·rows·h·itemsize`` bytes, five f32 operations per element."""
    from paddle1_tpu_torch.ops import softmax as psm
    errs, times = [], []
    for rows, h in SM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            g = torch.Generator(device=dev).manual_seed(SEED + 14 + rows + h)
            x = (torch.randn(rows, h, device=dev, generator=g) * 4).to(dtype)
            x[0, : h // 2] = -float("inf")
            y = psm.softmax_fwd(x)
            want = psm.softmax_ref(x)
            torch.cuda.synchronize()
            tag = f"[{rows}, {h}] {str(dtype).split('.')[-1]}"
            check(y.dtype == dtype and bool(torch.isfinite(y).all()),
                  f"softmax {tag}: non-finite output or wrong dtype")
            check(float(y[0, : h // 2].abs().max()) == 0.0,
                  f"softmax {tag}: a -inf entry has probability")
            err = float((y.float() - want.float()).abs().max())
            if dtype == torch.float32:
                check(err <= SM_TOL, f"softmax {tag}: err {err} > {SM_TOL}")
            else:
                rel = BF16_REL if dtype == torch.bfloat16 else F16_REL
                ex = float(((y.float() - want.float()).abs() -
                            rel * want.float().abs()).max())
                check(ex <= BF16_ABS, f"softmax {tag}: {ex} beyond one "
                      "rounding step")
            check(torch.equal(psm.softmax_fwd(x), y),
                  f"softmax {tag}: a repeat differs")
            errs.append({"shape": [rows, h], "dtype": str(dtype),
                         "max_abs_err": err})
            del x, y, want
        torch.cuda.empty_cache()
    grad_err = 0.0
    for rows, h in SM_SHAPES[:2]:
        g = torch.Generator(device=dev).manual_seed(SEED + 15 + h)
        x = torch.randn(rows, h, device=dev, generator=g)
        dy = torch.randn(rows, h, device=dev, generator=g)
        xk = x.clone().requires_grad_(True)
        psm.fused_softmax(xk).backward(dy)
        xr = x.clone().requires_grad_(True)
        torch.softmax(xr, dim=-1).backward(dy)
        grad_err = max(grad_err, float((xk.grad - xr.grad).abs().max()))
    check(grad_err <= SM_TOL, f"softmax autograd: dx differs from plain "
          f"autograd by {grad_err} > {SM_TOL}")
    log(f"softmax: f32, bf16 and f16 within tolerance at "
        f"{[list(s) for s in SM_SHAPES]}, repeats bit-identical; autograd "
        f"dx within {grad_err:.3g} of plain autograd")
    for rows, h in SM_SHAPES:
        need = 2 * rows * h * 2
        n_sets = max(1, min(4, -(-200_000_000 // need)))
        g = torch.Generator(device=dev).manual_seed(SEED + 16)
        xs = [torch.randn(rows, h, device=dev, generator=g).to(
            torch.bfloat16) for _ in range(n_sets)]
        t = {"ms": graph_time_ms([lambda x=x: psm.softmax_fwd(x)
                                  for x in xs]),
             "plain_ms": graph_time_ms([lambda x=x: psm.softmax_ref(x)
                                        for x in xs]),
             "library_ms": graph_time_ms([
                 lambda x=x: torch.softmax(x, dim=-1) for x in xs])}
        b_ms, by = bound(need, 5.0 * rows * h, F32_FLOPS_PER_S)
        times.append({"shape": [rows, h], "dtype": "bf16", **t,
                      "library_covers": "torch.softmax (last axis)",
                      "bound_ms": b_ms, "bound_by": by, "bound_bytes": need,
                      "input_sets": n_sets})
        log(f"softmax bf16 [{rows}, {h}]: kernel {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms, torch.softmax {t['library_ms']:.5f} "
            f"ms, bound {b_ms:.5f} ms ({by})")
        del xs
        torch.cuda.empty_cache()
    return errs, times, grad_err


# ---------------------------------------------------------------------------
# phase 15: eager LeNet (BASELINE config 1, the fifth main path)


def lenet_batches(paddle, n=2, seed=0, batch=LENET_BATCH):
    """``n`` seeded batches of ``batch`` x 1 x 28 x 28 images and labels
    as Paddle tensors on the current place (benches.py:60-70)."""
    rng = np.random.default_rng(seed)
    return [(paddle.to_tensor(rng.standard_normal(
        (batch, 1, 28, 28)).astype(np.float32)),
        paddle.to_tensor(rng.integers(0, 10, (batch,)).astype(
            np.int64))) for _ in range(n)]


def lenet_step_fn(paddle, model, opt, batches):
    """benches.py:72-78's eager step over the staged batches in turn."""
    F = paddle.nn.functional
    turn = [0]

    def step():
        x, y = batches[turn[0] % len(batches)]
        turn[0] += 1
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def facade_op_us(dev, n=2000):
    """Host µs per op of a small add on Paddle tensors and on plain
    tensors (the re-wrapping's cost per op), each timed twice in turns."""
    import paddle1_tpu_torch as paddle
    a = paddle.to_tensor(np.ones(16, np.float32))
    pa = a.as_subclass(torch.Tensor)
    out = {"facade": [], "plain": []}
    for kind in ("facade", "plain", "plain", "facade"):
        x = a if kind == "facade" else pa
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x + x
        torch.cuda.synchronize()
        out[kind].append((time.perf_counter() - t0) * 1e6 / n)
    return {k: min(v) for k, v in out.items()}


def plain_twin(model):
    """A deep copy of ``model`` whose parameters are plain
    ``torch.nn.Parameter``s (no Paddle facade, so no re-wrapping)."""
    import copy
    twin = copy.deepcopy(model)
    for mod in twin.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    p.detach().as_subclass(torch.Tensor),
                    requires_grad=p.requires_grad)
    return twin


def lenet_phase(dev):
    """Eager LeNet on Paddle tensors: 2 warm-up steps, then slope+readback
    timing over LENET_STEPS steps with the counters zeroed just before and
    read just after (1 fused Adam launch a step, no softmax); the same loop
    on a twin with plain torch parameters and inputs (the facade's host
    cost), in turns; then a prediction under no_grad with exactly one
    softmax launch."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.ops import fused_adam as fad
    from paddle1_tpu_torch.ops import softmax as psm
    from paddle1_tpu_torch.vision.models import LeNet
    F = paddle.nn.functional
    paddle.seed(SEED)
    model = LeNet()
    check(all(isinstance(p, paddle.Parameter) and p.device.type == "cuda"
              and not p.stop_gradient for p in model.parameters()),
          "LeNet's parameters are not Paddle Parameters on the card")
    twin = plain_twin(model)
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())
    batches = lenet_batches(paddle)
    check(batches[0][0].place == paddle.CUDAPlace(dev.index or 0) and
          isinstance(batches[0][0], paddle.Tensor),
          "to_tensor did not stage the batch on the card")
    step = lenet_step_fn(paddle, model, opt, batches)
    loss0 = float(step().numpy())
    step()
    counters = {"fused_adam": fad.fused_adam_,
                "softmax": psm.fused_softmax}
    for fn in counters.values():
        fn.launches = 0
    slopes, last, steps = timed_steps(step, LENET_STEPS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(isinstance(last, paddle.Tensor), "the loss is not a Paddle Tensor")
    loss_end = float(last.numpy())
    check(np.isfinite(loss0) and np.isfinite(loss_end),
          f"non-finite loss {loss0} / {loss_end}")
    check(loss_end < loss0, f"loss did not fall: {loss0} -> {loss_end}")
    check(launches == {"fused_adam": steps, "softmax": 0},
          f"{steps} eager steps launched {launches}, want {steps} fused "
          "Adam and no softmax")

    topt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=twin.parameters())
    plain_batches = [(x.as_subclass(torch.Tensor), y.as_subclass(
        torch.Tensor)) for x, y in batches]
    plain_step = lenet_step_fn(paddle, twin, topt, plain_batches)
    check(type(plain_step()) is torch.Tensor, "the twin is not plain")
    plain_step()
    facade_ms, plain_ms = [float(np.median(slopes)) * 1e3], []
    for fn, acc in ((plain_step, plain_ms), (plain_step, plain_ms),
                    (step, facade_ms)):
        acc.append(float(np.median(timed_steps(fn, LENET_STEPS)[0])) * 1e3)
    per_op = facade_op_us(dev)

    with paddle.no_grad():
        for fn in counters.values():
            fn.launches = 0
        x = batches[0][0]
        probs = F.softmax(model(x))
        torch.cuda.synchronize()
        pred_launches = {k: fn.launches for k, fn in counters.items()}
        logits = model(x)
    check(pred_launches == {"fused_adam": 0, "softmax": 1},
          f"the prediction launched {pred_launches}, want one softmax")
    p = probs.numpy()
    check(isinstance(probs, paddle.Tensor) and probs.stop_gradient and
          p.shape == (LENET_BATCH, 10), "prediction: not a [64, 10] Tensor "
          "without gradient")
    row_err = float(np.abs(p.sum(-1) - 1.0).max())
    check(row_err <= 1e-5, f"prediction rows sum to 1 within {row_err}")
    check(bool((p.argmax(-1) == logits.numpy().argmax(-1)).all()),
          "prediction: argmax differs from the logits'")
    dt = float(np.median(facade_ms)) / 1e3
    summary = {
        "train": "lenet_eager", "batch": LENET_BATCH, "dtype": "float32",
        "params": sum(p.nelement() for p in model.parameters()),
        "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3, "samples_per_s": LENET_BATCH / dt,
        "step_ms_facade_runs": facade_ms, "step_ms_plain_runs": plain_ms,
        "facade_host_ms_per_step": float(np.median(facade_ms)) -
        float(np.median(plain_ms)),
        "op_host_us": per_op,
        "loss_first": loss0, "loss_last": loss_end,
        "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "predict_launches": pred_launches, "predict_row_sum_err": row_err,
    }
    log(json.dumps(summary))
    return summary


def lenet_reference_check(dev):
    """f32, from identical seeded weights: LENET_REF_STEPS eager steps and
    a prediction on the kernel path against the plain path (the
    ``fused_softmax`` and ``fused_adam`` flags ``never``); then save the
    kernel path's model and Adam state, load both into a fresh LeNet and
    Adam, and take one more step on each: bit-identical."""
    import os
    import tempfile
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.ops import fused_adam as fad
    from paddle1_tpu_torch.ops import softmax as psm
    from paddle1_tpu_torch.vision.models import LeNet
    F = paddle.nn.functional
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        batches = lenet_batches(paddle, 1, seed=1)
        runs = {}
        for path, flags in (("kernel", {}),
                            ("plain", {"fused_softmax": "never",
                                       "fused_adam": "never"})):
            with flags_guard(flags):
                # each model in a fresh name space, as in its own process:
                # the Adam state is keyed by parameter name
                with paddle.utils.unique_name.guard():
                    model = LeNet(
                        generator=torch.Generator().manual_seed(SEED))
                opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                            parameters=model.parameters())
                step = lenet_step_fn(paddle, model, opt, batches)
                n_adam, n_sm = fad.fused_adam_.launches, \
                    psm.fused_softmax.launches
                losses = [float(step().numpy())
                          for _ in range(LENET_REF_STEPS)]
                with paddle.no_grad():
                    probs = F.softmax(model(batches[0][0]))
                torch.cuda.synchronize()
                runs[path] = {"losses": losses, "model": model, "opt": opt,
                              "probs": probs, "launches": (
                                  fad.fused_adam_.launches - n_adam,
                                  psm.fused_softmax.launches - n_sm)}
        k, p = runs["kernel"], runs["plain"]
        check(k["launches"] == (LENET_REF_STEPS, 1) and
              p["launches"] == (0, 0), f"reference check launches: kernel "
              f"{k['launches']}, plain {p['launches']}")
        loss_err = max(abs(a - b) for a, b in zip(k["losses"], p["losses"]))
        param_err = max(float((a - b).abs().max()) for a, b in
                        zip(k["model"].parameters(), p["model"].parameters()))
        prob_err = float((k["probs"] - p["probs"]).abs().max())
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "lenet.pdckpt")
            paddle.save({"model": k["model"].state_dict(),
                         "opt": k["opt"].state_dict()}, path)
            ck = paddle.load(path)
        with paddle.utils.unique_name.guard():
            fresh = LeNet()
        fresh.load_state_dict(ck["model"])
        fopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                     parameters=fresh.parameters())
        fopt.set_state_dict(ck["opt"])
        on = float(lenet_step_fn(paddle, k["model"], k["opt"], batches)()
                   .numpy())
        resumed = float(lenet_step_fn(paddle, fresh, fopt, batches)()
                        .numpy())
        resume_equal = on == resumed and all(
            torch.equal(a, b) for a, b in zip(k["model"].parameters(),
                                              fresh.parameters()))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    out = {"steps": LENET_REF_STEPS, "losses_kernel": k["losses"],
           "losses_plain": p["losses"], "max_loss_err": loss_err,
           "max_param_err": param_err, "max_prob_err": prob_err,
           "resume_loss": [on, resumed], "resume_bit_identical": resume_equal}
    log(json.dumps({"lenet_reference_check": out}))
    check(loss_err <= LENET_REF_TOL and param_err <= LENET_REF_TOL,
          f"LeNet kernel path against plain path: loss {loss_err}, params "
          f"{param_err} > {LENET_REF_TOL}")
    check(prob_err <= SM_TOL, f"LeNet probabilities differ by {prob_err} > "
          f"{SM_TOL}")
    check(resume_equal, f"a step after save/load differs from the "
          f"uninterrupted run: {on} vs {resumed}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the given-statistics batch norm at YOLOv3's widths


def yolo_bn_phase(dev):
    """Row 9 against its plain version at every [rows, C] that YOLOv3's
    eval forward at batch 8 x 416² gives it (YOLO_BN_SHAPES; C from 32),
    f32 and bf16, identity and relu, repeats bit-identical; then timed in
    f32 and bf16 at the seven YOLO_BN_TIMED shapes over 4 input sets in
    turn beside its plain version, ``F.batch_norm``'s eval forward on the
    same rows as a channels-last [8, C, H, W] tensor, and its bound."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    errs, times = [], []
    eps = 1e-5
    for rows, c in YOLO_BN_SHAPES:
        tx, ty, _ = fbn.block_width(c)
        for dtype in (torch.float32, torch.bfloat16):
            (x, g, b, _, m, v, _), = bn_inputs(dev, rows, c, dtype,
                                               SEED + 16 + rows + c)
            for act in ("identity", "relu"):
                tag = (f"[{rows}, {c}] {str(dtype).split('.')[-1]} "
                       f"act={act} (block {tx} x {ty})")
                y = fbn._norm_fwd(x, m, v, g, b, None, eps, act)
                want = fbn.fused_bn_norm_ref(x, m, v, g, b, eps, act)
                torch.cuda.synchronize()
                check(y.dtype == dtype and bool(torch.isfinite(y).all()),
                      f"fused_bn_norm {tag}: non-finite output or dtype "
                      f"{y.dtype}")
                exc = row_excess(y, want)
                check(exc <= 0.0, f"fused_bn_norm {tag}: rows differ from "
                      f"the plain version by {exc} beyond the tolerance")
                check(torch.equal(fbn._norm_fwd(x, m, v, g, b, None, eps,
                                                act), y),
                      f"fused_bn_norm {tag}: a repeat differs")
                errs.append({"shape": [rows, c], "dtype": str(dtype),
                             "act": act, "block": [tx, ty],
                             "max_abs_err": float((y.float() -
                                                   want.float()).abs().max())})
            del x, g, b, m, v, y, want
    log(f"fused_bn_norm at YOLOv3's {len(YOLO_BN_SHAPES)} shapes: f32 and "
        "bf16 x identity/relu within tolerance, repeats bit-identical")
    tbf = torch.nn.functional.batch_norm
    for rows, c in YOLO_BN_TIMED:
        side = int(round((rows // YOLO_BATCH) ** 0.5))
        check(side * side * YOLO_BATCH == rows, f"{rows} rows are not "
              f"{YOLO_BATCH} square images")
        for dtype in (torch.float32, torch.bfloat16):
            sets = bn_inputs(dev, rows, c, dtype, SEED + 17, n_sets=4)
            lib = [(s[0].view(YOLO_BATCH, side, side, c).permute(0, 3, 1, 2),
                    s[1].float(), s[2].float(), s[4], s[5]) for s in sets]
            check(lib[0][0].is_contiguous(memory_format=torch.channels_last),
                  "library input is not channels-last")
            t = {"ms": graph_time_ms([lambda s=s: fbn._norm_fwd(
                     s[0], s[4], s[5], s[1], s[2], None, eps, "identity")
                     for s in sets]),
                 "plain_ms": graph_time_ms([
                     lambda s=s: fbn.fused_bn_norm_ref(s[0], s[4], s[5], s[1],
                                                       s[2], eps)
                     for s in sets]),
                 "library_ms": graph_time_ms([
                     lambda s=s: tbf(s[0], s[3], s[4], s[1], s[2], False,
                                     0.1, eps) for s in lib])}
            size = torch.finfo(dtype).bits // 8
            need, _ = bn_bytes("fused_bn_norm", rows, c, size)
            b_ms, by = bound(need, BN_FLOPS["fused_bn_norm"] * rows * c,
                             F32_FLOPS_PER_S)
            name = str(dtype).split(".")[-1]
            times.append({"shape": [rows, c], "dtype": name,
                          "act": "identity", "residual": False, **t,
                          "library_covers": "F.batch_norm eval forward on "
                                            "channels-last NCHW",
                          "bound_ms": b_ms, "bound_by": by,
                          "bound_bytes": need})
            log(f"fused_bn_norm {name} [{rows}, {c}] ({side}²): kernel "
                f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
                f"F.batch_norm {t['library_ms']:.5f} ms, bound {b_ms:.5f} ms "
                f"({by})")
            del sets, lib
        torch.cuda.empty_cache()
    return errs, times


# ---------------------------------------------------------------------------
# phase 17: YOLOv3 inference (BASELINE config 5, the sixth main path)


def yolo_model(dev, seed):
    """``yolov3(num_classes=80)`` on the card with seeded weights, its 72
    batch norms calibrated on one seeded batch of YOLO_BATCH x 416²
    (momentum 0 for one training-mode forward under no_grad, so that the
    running statistics become that batch's), then ``eval()``. Fresh
    statistics make each batch norm nearly the identity, and 75 seeded
    convolutions then shrink the heads towards 0."""
    from paddle1_tpu_torch.nn import BatchNorm2D
    from paddle1_tpu_torch.vision.models import yolov3
    model = yolov3(num_classes=YOLO_CLASSES,
                   generator=torch.Generator().manual_seed(seed))
    check(all(t.device.type == "cuda" for t in model.state_dict().values()),
          "yolov3 did not default to the card")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2D)]
    check(len(bns) == YOLO_BNS, f"yolov3 has {len(bns)} batch norms")
    for bn in bns:
        bn._momentum = 0.0
    rng = np.random.default_rng(seed + 1)
    calib = torch.from_numpy(rng.standard_normal(
        (YOLO_BATCH, 3, YOLO_IMG, YOLO_IMG)).astype(np.float32)).to(dev)
    model.train()
    with torch.no_grad():
        model(calib)
    model.eval()
    return model


def conv_flops(model, x):
    """Multiply-adds x 2 of every convolution of one forward of ``model``
    on ``x``, from the shapes its Conv2D layers see (forward hooks)."""
    from paddle1_tpu_torch.nn import Conv2D
    total = [0]

    def hook(mod, inp, out):
        w = mod.weight
        total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, Conv2D)]
    with torch.no_grad():
        model(x)
    for h in hs:
        h.remove()
    return total[0]


def bn_input_shapes(model, x):
    """The ``[rows, C]`` each batch norm of ``model`` gets in one forward
    on ``x``."""
    from paddle1_tpu_torch.nn import BatchNorm2D
    seen = []

    def hook(mod, inp):
        n, c, h, w = inp[0].shape
        seen.append((n * h * w, c))
    hs = [m.register_forward_pre_hook(hook) for m in model.modules()
          if isinstance(m, BatchNorm2D)]
    with torch.no_grad():
        model(x)
    for h in hs:
        h.remove()
    return seen


# device kernels of a YOLOv3 forward by what they do: a layout copy is a
# copy kernel (contiguous, a memory-format conversion, a cast) or a
# device-to-device memcpy; torch.cat's own kernel (CatArrayBatchedCopy) is
# the concat, the index gathers the nearest upsample; "add" is the
# DarkBlocks' residual sums and the heads' bias; cuDNN's f32 engines
# transpose channels-last activations to channels-first and back inside
# the convolution (its own kernels, counted apart from the program's
# layout copies); the rest of cuDNN's kernels (implicit GEMM, FFT) are
# the convolutions
YOLO_KERNEL_KINDS = (("batch_norm", ("normalize_kernel",)),
                     ("cudnn_transpose", ("nchwToNhwc", "nhwcToNchw")),
                     ("leaky_relu", ("leaky_relu",)),
                     ("concat", ("CatArray",)),
                     ("upsample", ("index", "Index")),
                     ("layout_copy", ("copy_kernel", "Memcpy DtoD",
                                      "direct_copy")),
                     ("add", ("AddFunctor", "add_kernel",
                              "CUDAFunctor_add")),
                     ("conv", ("conv", "Conv", "xmma", "gemm", "cudnn",
                               "sm90", "sm80", "implicit", "winograd",
                               "fft", "cutlass", "_complex")))


def yolo_kernel_kind(name):
    for kind, pieces in YOLO_KERNEL_KINDS:
        if any(p in name for p in pieces):
            return kind
    return "other"


def yolo_profile_window(model, x):
    """The device events of one eval forward under ``torch.profiler``:
    the third of three forwards (one skipped, one warming it up), with
    YOLO_PROFILE_GAP_S of host idle between the window's edges and the
    forward's first launch and last completion. The profiler drops every
    kernel whose timestamp falls outside its window, and late in the
    smoke's long process a window that opened on the forward itself has
    lost the forward's first three kernels (the input's layout copy, the
    first convolution and its batch norm)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            time.sleep(YOLO_PROFILE_GAP_S)
            with torch.no_grad():
                heads = model(x)
            float(heads[2][0, 0, 0, 0])
            torch.cuda.synchronize()
            time.sleep(YOLO_PROFILE_GAP_S)
            prof.step()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def yolo_forward_profile(model, x):
    """One eval forward's device kernels by kind (count and ms), the
    layout copies by name, the busy time and the 12 longest kernels. The
    window must hold the whole forward, its 72 batch-norm launches: up to
    YOLO_PROFILE_WINDOWS windows are taken, the first whole one is read,
    and the batch-norm count of each is kept."""
    windows = []
    for _ in range(YOLO_PROFILE_WINDOWS):
        events = yolo_profile_window(model, x)
        check(events, "the profiler saw no device work in the YOLOv3 "
              "forward")
        windows.append(sum("normalize_kernel" in e.name for e in events))
        if windows[-1] == YOLO_BNS:
            break
    check(windows[-1] == YOLO_BNS, f"no profiled window held one forward's "
          f"{YOLO_BNS} batch-norm kernels: {windows}")
    kinds, copies, by_name = {}, {}, {}
    for e in events:
        kind = yolo_kernel_kind(e.name)
        n, us = kinds.get(kind, (0, 0.0))
        kinds[kind] = (n + 1, us + e.time_range.elapsed_us())
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        if kind == "layout_copy":
            copies[e.name] = copies.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"kernels": len(events), "window_batch_norms": windows,
            "busy_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3,
            "by_kind": {k: {"count": n, "ms": us / 1e3}
                        for k, (n, us) in sorted(kinds.items())},
            "layout_copies": sum(copies.values()),
            "layout_copy_kernels": copies,
            "top_kernels": [{"name": k[:120], "count": n, "ms": us / 1e3}
                            for k, (n, us) in top]}


def yolo_phase(dev):
    """YOLOv3 inference as ``benches.py:257-310`` drives it: the
    calibrated model, a seeded batch staged on the card once, a warm-up
    forward, slope+readback timing over YOLO_STEPS forwards with the
    counters zeroed just before and read just after (72 given-statistics
    launches a forward, no training-mode one); one profiled forward
    (layout copies at most YOLO_MAX_COPIES); then the postprocess, a warm
    pass and a timed one."""
    t0 = time.perf_counter()
    model = yolo_model(dev, SEED)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (YOLO_BATCH, 3, YOLO_IMG, YOLO_IMG)).astype(np.float32)).to(dev)
    shapes = bn_input_shapes(model, x)
    check(len(shapes) == YOLO_BNS and set(shapes) == set(YOLO_BN_SHAPES),
          f"YOLOv3's batch norms get {sorted(set(shapes))}, phase 16 "
          f"checks {sorted(YOLO_BN_SHAPES)}")
    flops = conv_flops(model, x)
    setup_s = time.perf_counter() - t0
    counters = bn_counters()
    torch.cuda.reset_peak_memory_stats()

    def step():
        with torch.no_grad():
            return model(x)[2][0, 0, 0, 0]
    step()
    zero(counters)
    slopes, _, steps = timed_steps(step, YOLO_STEPS)
    torch.cuda.synchronize()
    launches = bn_launches(counters)
    want = {"fused_bn_train": 0, "fused_bn_norm": YOLO_BNS * steps,
            "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": 0}
    check(launches == want, f"{steps} YOLOv3 forwards launched {launches}, "
          f"want {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        heads = model(x)
    head_std = []
    for h, stride in zip(heads, (32, 16, 8)):
        side = YOLO_IMG // stride
        check(tuple(h.shape) == (YOLO_BATCH, 3 * (5 + YOLO_CLASSES), side,
                                 side) and bool(torch.isfinite(h).all()),
              f"head {tuple(h.shape)} is not a finite [{YOLO_BATCH}, 255, "
              f"{side}, {side}]")
        head_std.append(float(h.std()))
        check(head_std[-1] > YOLO_MIN_STD, f"head [{side}, {side}] vanished "
              f"(std {head_std[-1]})")
    prof = yolo_forward_profile(model, x)
    log(json.dumps({"yolov3_forward_profile": prof}))
    check(prof["layout_copies"] <= YOLO_MAX_COPIES,
          f"{prof['layout_copies']} layout copies in one YOLOv3 forward, "
          f"more than {YOLO_MAX_COPIES}: {prof['layout_copy_kernels']}")
    img_size = np.tile([[YOLO_IMG, YOLO_IMG]], (YOLO_BATCH, 1)).astype(
        np.int32)
    model.postprocess(heads, img_size)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = model.postprocess(heads, img_size)
    post_ms = (time.perf_counter() - t1) * 1e3
    check(len(results) == YOLO_BATCH and all(
        r.shape[1:] == (6,) and r.shape[0] <= 100 for r in results),
        "postprocess: not one [M <= 100, 6] result per image")
    dt = float(np.median(slopes))
    summary = {
        "infer": "yolov3", "dtype": "float32", "batch": YOLO_BATCH,
        "img": YOLO_IMG, "classes": YOLO_CLASSES,
        "params": sum(p.nelement() for p in model.parameters()),
        "batch_norms": YOLO_BNS, "setup_s": setup_s, "steps": steps,
        "timing": "slope+readback", "step_ms_median": dt * 1e3,
        "step_ms_min": min(slopes) * 1e3, "step_ms_max": max(slopes) * 1e3,
        "images_per_s": YOLO_BATCH / dt,
        "postprocess_ms_per_batch": post_ms,
        "detections_img0": int(results[0].shape[0]),
        "peak_mem_gb": peak, "conv_flops_per_forward": flops,
        "f32_peak_share": flops / dt / F32_FLOPS_PER_S,
        "head_std": head_std, "launches": launches,
        "launches_per_forward": {k: n / steps for k, n in launches.items()},
        "layout_copies": prof["layout_copies"],
        "cudnn_transposes": prof["by_kind"].get(
            "cudnn_transpose", {"count": 0})["count"],
        "device_busy_ms": prof["busy_ms"],
        "device_ms_by_kind": {k: v["ms"] for k, v in
                              prof["by_kind"].items()},
    }
    log(json.dumps(summary))
    del model, x, heads
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 18: YOLOv3 kernel path against plain path


def yolo_reference_check(dev):
    """Full width and depth, f32, from identical calibrated weights: the
    kernel path against the plain path (``fused_bn="never"``) at
    YOLO_REF_BATCH x 416². Each head within YOLO_REF_TOL of its max abs
    value; ``yolo_box``'s boxes (over the image size) and scores within
    YOLO_REF_TOL; the plain path's ``multiclass_nms`` on the kernel
    path's decoded arrays equal to the kernel path's postprocess. The
    batch norms' affine weights are moved off their init (gamma 1 + 0.1 N,
    beta 0.1 N, seeded): at gamma 1 and beta 0 the kernel's fused
    multiply-add and the plain path's two roundings agree bit for bit."""
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.nn import BatchNorm2D
    from paddle1_tpu_torch.vision import ops as V
    from paddle1_tpu_torch.vision.models import yolov3
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        kernel = yolo_model(dev, SEED + 18)
        gen = torch.Generator().manual_seed(SEED + 19)
        with torch.no_grad():
            for bn in kernel.modules():
                if isinstance(bn, BatchNorm2D):
                    c = bn.weight.shape[0]
                    bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
                    bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
        plain = yolov3(num_classes=YOLO_CLASSES, device=dev)
        plain.load_state_dict(kernel.state_dict())
        plain.eval()
        rng = np.random.default_rng(18)
        x = torch.from_numpy(rng.standard_normal(
            (YOLO_REF_BATCH, 3, YOLO_IMG, YOLO_IMG)).astype(
                np.float32)).to(dev)
        img = torch.tensor([[YOLO_IMG, YOLO_IMG]] * YOLO_REF_BATCH,
                           dtype=torch.int32)
        counters = bn_counters()
        runs = {}
        for path, flags, model in (("kernel", {}, kernel),
                                   ("plain", {"fused_bn": "never"}, plain)):
            zero(counters)
            with flags_guard(flags), torch.no_grad():
                heads = model(x)
                dec = []
                for h, mask, stride in zip(heads, model.anchor_masks,
                                           (32, 16, 8)):
                    sub = [a for m in mask
                           for a in model.anchors[2 * m:2 * m + 2]]
                    dec.append(V.yolo_box(h, img, sub, YOLO_CLASSES, 0.01,
                                          stride))
                boxes = torch.cat([b for b, _ in dec], 1)
                scores = torch.cat([s for _, s in dec], 1)
                post = model.postprocess(heads, img)
            torch.cuda.synchronize()
            runs[path] = {"heads": heads, "boxes": boxes, "scores": scores,
                          "post": post, "launches": bn_launches(counters)}
        k, p = runs["kernel"], runs["plain"]
        check(k["launches"]["fused_bn_norm"] == YOLO_BNS and
              p["launches"]["fused_bn_norm"] == 0,
              f"reference check launches: kernel {k['launches']}, plain "
              f"{p['launches']}")
        head_err = []
        for a, b in zip(k["heads"], p["heads"]):
            head_err.append(float((a - b).abs().max() / b.abs().max()))
            check(float(b.std()) > YOLO_MIN_STD, "a plain-path head vanished")
        box_err = float((k["boxes"] - p["boxes"]).abs().max()) / YOLO_IMG
        score_err = float((k["scores"] - p["scores"]).abs().max())
        kb, ks = k["boxes"].cpu().numpy(), k["scores"].cpu().numpy()
        with flags_guard({"fused_bn": "never"}):
            nms = [V.multiclass_nms(kb[i], ks[i].T, score_threshold=0.01)
                   for i in range(YOLO_REF_BATCH)]
        nms_equal = all(torch.equal(a, b) for a, b in zip(nms, k["post"]))
        detections = [int(r.shape[0]) for r in k["post"]]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = det
    out = {"batch": YOLO_REF_BATCH, "img": YOLO_IMG,
           "head_err_over_max_abs": head_err, "box_err_over_img": box_err,
           "score_err": score_err, "nms_identical": nms_equal,
           "detections": detections}
    log(json.dumps({"yolov3_reference_check": out}))
    check(max(head_err) <= YOLO_REF_TOL, f"YOLOv3 heads: kernel path against "
          f"plain path {head_err} > {YOLO_REF_TOL} of their max abs value")
    check(box_err <= YOLO_REF_TOL and score_err <= YOLO_REF_TOL,
          f"yolo_box: boxes {box_err} (over the image size), scores "
          f"{score_err} > {YOLO_REF_TOL}")
    check(nms_equal, "multiclass_nms on the kernel path's decoded arrays "
          "differs from the kernel path's postprocess")
    del kernel, plain, runs
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 19: ERNIE-1.5B pretraining (BASELINE config 4, the seventh main path)


def adam_ernie_phase(dev):
    """The fused AdamW kernel over ERNIE-1.5B's 398 parameter tensors
    (1.64 B elements, int64 offsets): held to its plain version on every
    tensor in f32 and in bf16, timed in f32 beside the plain per-tensor
    update, its bound and ``torch.optim.AdamW(fused=True,
    capturable=True)`` (kernel and library in five alternating rounds of
    CUDA-graph replays, :func:`alternating_ms`);
    then the engine's ``check_finite`` work at the same scale: the
    detection (an L1 norm of every gradient) and the keep-select
    (``snapshot_`` of parameters and both moments, ``keep_where_`` back),
    each timed, the keep-select restoring every tensor bit for bit when
    the step is bad."""
    from paddle1_tpu_torch.distributed.parallel_engine import (keep_where_,
                                                               snapshot_)
    from paddle1_tpu_torch.ops import fused_adam as fad
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    shapes = ernie_shapes()
    n_el = sum(int(np.prod(s)) for s in shapes)
    sc = torch.tensor([ERNIE_LR, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    decays = [0.01] * len(shapes)
    b1, b2, eps = 0.9, 0.999, 1e-8
    ts = adam_tensors(shapes, torch.bfloat16, g, dev)
    err_bf16 = adam_check(fad, ts, sc, decays, None,
                          f"at ERNIE's {n_el} elements, bf16")
    del ts
    torch.cuda.empty_cache()
    ps, gs, m1, m2 = adam_tensors(shapes, torch.float32, g, dev)
    err = adam_check(fad, (ps, gs, m1, m2), sc, decays, None,
                     f"at ERNIE's {n_el} elements, f32")

    def plain():
        for p, q, a, b in zip(ps, gs, m1, m2):
            np_, na, nb = fad.fused_adam_ref(p, q, a, b, sc[0], sc[1], sc[2],
                                             0.01, b1, b2, eps)
            p.copy_(np_)
            a.copy_(na)
            b.copy_(nb)
    plain_ms = graph_time_ms([plain], reps=3)
    torch.cuda.empty_cache()
    lib_ps = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    for p, q in zip(lib_ps, gs):
        p.grad = q
    lib_opt = torch.optim.AdamW(lib_ps, lr=ERNIE_LR, weight_decay=0.01,
                                fused=True, capturable=True)
    timed = alternating_ms({"kernel": lambda: fad.fused_adam_(
        ps, gs, m1, m2, sc, decays, b1, b2, eps), "library": lib_opt.step},
        reps=10)
    ms, lib_ms = timed["kernel"]["median_ms"], timed["library"]["median_ms"]
    del lib_ps, lib_opt
    torch.cuda.empty_cache()
    b_ms, by = bound(28.0 * n_el, 12.0 * n_el, F32_FLOPS_PER_S)
    # check_finite: detection over the gradients, then the keep-select
    # over parameters and moments (12 B a parameter)
    state = ps + m1 + m2
    backup = [torch.empty_like(t) for t in state]
    bad = torch.zeros((), dtype=torch.bool, device=dev)

    def detect():
        return torch.isfinite(torch.stack(torch._foreach_norm(gs, 1))).all()
    detect_ms = graph_time_ms([detect], reps=10)
    keep_ms = graph_time_ms([lambda: (snapshot_(backup, state),
                                      keep_where_(state, backup, bad))],
                            reps=5)
    snapshot_(backup, state)
    fad.fused_adam_(ps, gs, m1, m2, sc, decays, b1, b2, eps)
    keep_where_(state, backup, bad)
    torch.cuda.synchronize()
    check(all(torch.equal(t, b) for t, b in zip(state, backup)),
          "keep_where_ on a bad step did not restore every tensor")
    # the function: a copy of the 12 B a parameter written once and read
    # once, the state written once (the read that fills the copy can share
    # the optimizer's own); as implemented (snapshot_, then keep_where_):
    # copy 12 B in and out, select 24 B in and 12 B out
    keep_bytes = 36.0 * n_el
    keep_impl_bytes = 60.0 * n_el
    keep_b_ms, _ = bound(keep_bytes, 0.0, F32_FLOPS_PER_S)
    keep_impl_b_ms, _ = bound(keep_impl_bytes, 0.0, F32_FLOPS_PER_S)
    detect_b_ms, _ = bound(4.0 * n_el, 2.0 * n_el, F32_FLOPS_PER_S)
    out = {"tensors": len(shapes), "elements": n_el, "max_abs_err": err,
           "max_abs_err_bf16": err_bf16, "ms": ms,
           "ms_spread": timed["kernel"]["spread_ms"], "plain_ms": plain_ms,
           "library_ms": lib_ms,
           "library_ms_spread": timed["library"]["spread_ms"],
           "rounds_ms": {k: v["rounds_ms"] for k, v in timed.items()},
           "library_covers": "torch.optim.AdamW(fused=True, "
                             "capturable=True).step (graph replay)",
           "bound_ms": b_ms, "bound_by": by,
           "check_finite_detect_ms": detect_ms,
           "check_finite_detect_bound_ms": detect_b_ms,
           "check_finite_keep_select_ms": keep_ms,
           "check_finite_keep_select_bound_ms": keep_b_ms,
           "check_finite_keep_select_bytes": keep_bytes,
           "check_finite_keep_select_impl_bound_ms": keep_impl_b_ms,
           "check_finite_keep_select_impl_bytes": keep_impl_bytes}
    log(f"fused_adam at ERNIE-1.5B ({len(shapes)} tensors, {n_el} f32 "
        f"elements, 1 launch): max_abs_err={err:.3e} {ms:.5f} ms (plain "
        f"{plain_ms:.5f}, AdamW(fused=True) {lib_ms:.5f}, bound {b_ms:.5f} "
        f"{by}); check_finite detect {detect_ms:.5f} ms (bound "
        f"{detect_b_ms:.5f}), keep-select {keep_ms:.5f} ms (bound "
        f"{keep_b_ms:.5f} for {keep_bytes / 1e9:.1f} GB; the two passes' "
        f"{keep_impl_bytes / 1e9:.1f} GB {keep_impl_b_ms:.5f})")
    del ps, gs, m1, m2, state, backup
    torch.cuda.empty_cache()
    return out


def ernie_batch(batch, seq, seed=0, accum=None, scale=None):
    """``benches.py:219-223``'s seeded batch (ids, MLM labels and NSP
    labels over ERNIE's vocabulary); with ``accum``, shaped ``[accum,
    batch, ...]``; with ``scale``, a ``scale`` leaf (one per micro-batch)
    the loss is multiplied by."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if accum is None else (accum, batch)
    v = ERNIE_VOCAB
    out = {"ids": rng.integers(1, v, lead + (seq,)).astype(np.int32),
           "mlm": rng.integers(0, v, lead + (seq,)).astype(np.int32),
           "nsp": rng.integers(0, 2, lead).astype(np.int32)}
    if scale is not None:
        out["scale"] = np.asarray(scale, np.float32)
    return out


def ernie_loss_fn(crit, scaled=False):
    def loss_fn(m, b):
        scores, rel = m(b["ids"])
        loss = crit(scores, rel, b["mlm"], b["nsp"])
        return loss * b["scale"] if scaled else loss
    return loss_fn


def ernie_model(depth=ERNIE_LAYERS, seed=SEED):
    from paddle1_tpu_torch.text.models import (ErnieForPretraining,
                                               ernie_1p5b)
    gen = torch.Generator().manual_seed(seed)
    return ErnieForPretraining(ernie_1p5b(
        num_hidden_layers=depth, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, generator=gen), generator=gen)


def ernie_engine(model, lr=ERNIE_LR, scaled=False, **kw):
    """Config 4's engine: ``build_mesh(dp=1, sharding=1)``, ZeRO stage 2
    (the identity at sharding 1), AdamW."""
    from paddle1_tpu_torch.distributed import ParallelEngine, build_mesh
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import BertPretrainingCriterion
    crit = BertPretrainingCriterion(model.bert.vocab_size)
    return ParallelEngine(model, AdamW(learning_rate=lr,
                                       parameters=model.parameters()),
                          ernie_loss_fn(crit, scaled),
                          mesh=build_mesh(dp=1, sharding=1), zero_stage=2,
                          **kw)


def ernie_phase(dev):
    """BASELINE config 4 at full width and depth: ``ErnieForPretraining(
    ernie_1p5b())`` + ``BertPretrainingCriterion`` + ``AdamW(1e-4)``
    through ``ParallelEngine(mesh=build_mesh(dp=1, sharding=1),
    zero_stage=2, amp_dtype="bfloat16")`` at batch 4 x 512: a warm-up
    step, then slope+readback timing on the repeated batch with the
    counters zeroed just before and read just after (24 flash forward,
    dK/dV and dQ launches and one fused AdamW a step, 50 LayerNorm
    launches a forward), a finite and falling loss; then two steps under
    ``torch.profiler``."""
    t0 = time.perf_counter()
    model = ernie_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc = model.bert.encoder
    attn = enc.layers[0].self_attn
    check(len(enc.layers) == ERNIE_LAYERS and attn.num_heads == ERNIE_HEADS
          and attn.head_dim == ERNIE_HIDDEN // ERNIE_HEADS and
          model.bert.vocab_size == ERNIE_VOCAB,
          "ernie_1p5b() is not hidden 2304, 24 layers, 18 heads of 128")
    check(all(p.device.type == "cuda" for p in model.parameters()),
          "ErnieForPretraining did not default to the card")
    n_params = sum(p.nelement() for p in model.parameters())
    eng = ernie_engine(model, amp_dtype="bfloat16")
    check(eng._flat is not None, "config 4's mesh did not take the dp arm")
    batch = ernie_batch(ERNIE_BATCH, ERNIE_SEQ)
    staged = eng.shard_batch(batch)
    torch.cuda.reset_peak_memory_stats()
    loss0 = float(eng.step(staged))          # warm-up: allocates
    setup_s = time.perf_counter() - t0
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    slopes, last, steps = timed_steps(lambda: eng.step(staged), 8)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    loss_end = float(last)
    check(np.isfinite(loss0) and np.isfinite(loss_end),
          f"ERNIE: non-finite loss {loss0} / {loss_end}")
    check(loss_end < loss0, f"ERNIE: loss did not fall: {loss0} -> "
          f"{loss_end}")
    want = {"flash_attention": ERNIE_LAYERS * steps,
            "flash_attention_bwd_dkv": ERNIE_LAYERS * steps,
            "flash_attention_bwd_dq": ERNIE_LAYERS * steps,
            "fused_adam": steps,
            "layer_norm": (2 * ERNIE_LAYERS + 2) * steps}
    for k, n in want.items():
        check(launches[k] == n, f"ERNIE: {k} launched {launches[k]} times "
              f"in {steps} steps, want {n}")
    peak = torch.cuda.max_memory_allocated()
    prof = device_kernels_per_step(lambda: eng.step(staged), 2)
    dt = float(np.median(slopes))
    busy = prof["device_busy_ms_per_step"]
    flops = (6 * n_params * ERNIE_BATCH * ERNIE_SEQ +
             12 * ERNIE_LAYERS * ERNIE_BATCH * ERNIE_SEQ ** 2 * ERNIE_HIDDEN)
    summary = {
        "train": "ernie_1p5b_pretraining", "amp": "bfloat16",
        "mesh": {"dp": 1, "sharding": 1}, "zero_stage": 2,
        "batch": ERNIE_BATCH, "seq_len": ERNIE_SEQ, "layers": ERNIE_LAYERS,
        "params": n_params, "init_s": init_s, "setup_s": setup_s,
        "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3,
        "samples_per_s": ERNIE_BATCH / dt,
        "tokens_per_s": ERNIE_BATCH * ERNIE_SEQ / dt,
        "flops_per_step": flops, "mfu": flops / dt / BF16_FLOPS_PER_S,
        "loss_first": loss0, "loss_last": loss_end,
        "peak_mem_gb": peak / 1e9, "peak_mem_gib": peak / 2 ** 30,
        "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        # the profiler's host work slows its window: the idle share is read
        # against the untraced slope, the window's beside it
        "device_idle_share": 1.0 - busy / (dt * 1e3),
        "profiler_window_idle_share": 1.0 - busy / prof["profiled_step_ms"],
        "profile": prof}
    log(json.dumps({"ernie": summary}))
    del eng, model, staged
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 20: ERNIE-1.5B f32 reference check and the engine's controls


def ernie_reference_check(dev):
    """Full width, f32. (a) Depth 2, batch 2 x 512 with ragged padded
    tails: REF_STEPS steps on the kernel path against REF_STEPS on the
    plain path (every kernel flag ``never``) from identical weights, as
    phase 7 does for BERT. (b) Depth 4, ``grad_accum=2`` (micro-batches
    of 2 x 512), ``clip_global_norm=1.0``, ``check_finite=True`` and
    ``LinearWarmup(PolynomialDecay(...))``: ``step_many`` over 4 batches
    equals 4 ``step`` calls of a twin engine bit for bit (losses,
    parameters, moments, step counts, schedules); the clipped gradient's
    norm is at most 1; a batch whose second micro-batch scales its loss by
    NaN returns ``.bad`` and leaves every parameter and moment bit for bit,
    and the step after it trains."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.optimizer import lr as sched
    counters = train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    # (a) kernel path against plain path
    m_kernel = ernie_model(depth=2, seed=SEED + 20)
    m_plain = copy.deepcopy(m_kernel)
    check(m_plain.cls.decoder_weight is
          m_plain.bert.embeddings.word_embeddings.weight,
          "deepcopy untied the decoder weight")
    rng = np.random.default_rng(SEED + 20)
    b = ERNIE_REF_BATCH
    batch = ernie_batch(b, ERNIE_SEQ, seed=SEED + 20)
    lens = rng.integers(128, ERNIE_SEQ + 1, b)
    pad = np.arange(ERNIE_SEQ)[None, :] >= lens[:, None]
    batch["ids"][pad] = 0
    batch["mlm"][pad] = -1

    def run(model):
        eng = ernie_engine(model)
        return [float(eng.step(batch)) for _ in range(REF_STEPS)]
    lk = run(m_kernel)
    mid = {k: fn.launches for k, fn in counters.items()}
    with flags_guard(flash_attention="never", flash_backward="never",
                     fused_adam="never", fused_layer_norm="never"):
        lp = run(m_plain)
    after = {k: fn.launches for k, fn in counters.items()}
    check(all(mid[k] > before[k] for k in counters),
          "ERNIE: the kernel path skipped a kernel")
    check(after == mid, "ERNIE: the plain path launched a kernel")
    loss_err = max(abs(a - c) for a, c in zip(lk, lp))
    check(loss_err <= REF_TOL, f"ERNIE: losses differ by {loss_err}: {lk} "
          f"vs {lp}")
    sk, sp = m_kernel.state_dict(), m_plain.state_dict()
    param_err, key_bias_err = 0.0, 0.0
    for k in sk:
        e = float((sk[k] - sp[k]).abs().max())
        if k.endswith("k_proj.bias"):
            key_bias_err = max(key_bias_err, e)
        else:
            param_err = max(param_err, e)
    check(param_err <= REF_TOL, f"ERNIE: params differ by {param_err}")
    check(key_bias_err <= REF_STEPS * ERNIE_LR, f"ERNIE: key biases differ "
          f"by {key_bias_err} > {REF_STEPS * ERNIE_LR}")
    del m_kernel, m_plain, sk, sp
    torch.cuda.empty_cache()

    # (b) the engine's controls
    def schedule():
        return sched.LinearWarmup(
            sched.PolynomialDecay(ERNIE_LR, decay_steps=8, end_lr=1e-6),
            warmup_steps=2, start_lr=ERNIE_LR / 10, end_lr=ERNIE_LR)
    m_a = ernie_model(depth=ERNIE_CTRL_DEPTH, seed=SEED + 21)
    m_b = copy.deepcopy(m_a)
    ctrl = dict(scaled=True, grad_accum=2, clip_global_norm=1.0,
                check_finite=True)
    eng_a = ernie_engine(m_a, lr=schedule(), **ctrl)
    eng_b = ernie_engine(m_b, lr=schedule(), **ctrl)
    batches = [ernie_batch(ERNIE_REF_BATCH, ERNIE_SEQ, seed=SEED + 30 + i,
                           accum=2, scale=[1.0, 1.0])
               for i in range(ERNIE_CTRL_K)]
    singles = [eng_a.step(bt) for bt in batches]
    many = eng_b.step_many(batches)
    torch.cuda.synchronize()
    check(torch.equal(torch.stack([f.tensor for f in singles]), many.tensor),
          f"ERNIE: step_many's [loss, bad] {many.tensor.tolist()} differ "
          f"from {ERNIE_CTRL_K} step calls'")
    check(not many.bad and all(np.isfinite(np.asarray(many))),
          f"ERNIE: a control step was bad or non-finite: "
          f"{many.tensor.tolist()}")
    check(all(torch.equal(p, q) for p, q in zip(eng_a.params, eng_b.params)),
          "ERNIE: step_many's parameters differ from the step calls'")
    sa, sb = eng_a.optimizer.state_dict(), eng_b.optimizer.state_dict()
    check(sa["step"] == sb["step"] == ERNIE_CTRL_K and
          sa["LR_Scheduler"] == sb["LR_Scheduler"] and
          all(torch.equal(sa[k], sb[k]) for k in sa
              if k not in ("step", "LR_Scheduler")),
          "ERNIE: step_many's moments, step count or schedule differ")
    grad_norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                     for g in eng_a._grads)))
    check(grad_norm <= 1.0 + 1e-5, f"ERNIE: the clipped gradient's norm is "
          f"{grad_norm} > 1")
    del eng_b, m_b, sb
    torch.cuda.empty_cache()
    keep = [p.detach().clone() for p in eng_a.params]
    slots = {k: v for k, v in sa.items() if k not in ("step", "LR_Scheduler")}
    lr_before = eng_a.optimizer.get_lr()
    poisoned = ernie_batch(ERNIE_REF_BATCH, ERNIE_SEQ, seed=SEED + 40,
                           accum=2, scale=[1.0, float("nan")])
    fut = eng_a.step(poisoned)
    check(fut.bad and fut.bad_count() == 1, "ERNIE: the poisoned step was "
          f"not flagged: {fut.tensor.tolist()}")
    check(all(torch.equal(p, q) for p, q in zip(keep, eng_a.params)),
          "ERNIE: the poisoned step moved a parameter")
    st = eng_a.optimizer.state_dict()
    check(st["step"] == ERNIE_CTRL_K and
          all(torch.equal(st[k], v) for k, v in slots.items()),
          "ERNIE: the poisoned step moved a moment or the step count")
    check(eng_a.optimizer.get_lr() != lr_before, "ERNIE: the schedule did "
          "not advance over the poisoned step")
    after_bad = eng_a.step(batches[0])
    check(not after_bad.bad and np.isfinite(float(after_bad)) and
          not all(torch.equal(p, q) for p, q in zip(keep, eng_a.params)),
          "ERNIE: the step after the poisoned one did not train")
    for k in counters:
        counters[k].launches = before[k]
    out = {"ernie_reference": {
        "dtype": "float32", "depth": 2, "batch": b, "seq": ERNIE_SEQ,
        "steps": REF_STEPS, "losses_kernel": lk, "losses_plain": lp,
        "max_loss_err": loss_err, "max_param_err": param_err,
        "max_key_bias_err": key_bias_err,
        "controls": {"depth": ERNIE_CTRL_DEPTH, "grad_accum": 2,
                     "micro_batch": ERNIE_REF_BATCH, "clip_global_norm": 1.0,
                     "check_finite": True, "k": ERNIE_CTRL_K,
                     "losses": np.asarray(many).tolist(),
                     "step_many_bit_equal": True,
                     "clipped_grad_norm": grad_norm,
                     "poisoned_step_bad": True,
                     "poisoned_step_bit_identical": True,
                     "loss_after_poisoned": float(after_bad)}}}
    log(json.dumps(out))
    del eng_a, m_a, keep, slots
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 21: BERT-base fine-tuning in eager dygraph


def ft_batches(paddle, batch, n=2, seed=0):
    """``n`` seeded batches of ``batch`` x FT_SEQ token ids as Paddle
    tensors on the current place, with ragged padding (each row keeps
    between a quarter and all of its tokens, the first row all; the rest
    are the pad id 0, so the ``[B, Nk]`` keep-mask reaches the flash
    kernels), and labels the model can learn: whether the first token is
    in the vocabulary's lower half."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, BERT_VOCAB, (batch, FT_SEQ))
        lens = rng.integers(FT_SEQ // 4, FT_SEQ + 1, batch)
        lens[0] = FT_SEQ
        ids[np.arange(FT_SEQ)[None, :] >= lens[:, None]] = 0
        labels = (ids[:, 0] < BERT_VOCAB // 2).astype(np.int64)
        out.append((paddle.to_tensor(ids.astype(np.int64)),
                    paddle.to_tensor(labels)))
    return out


def ft_classifier(paddle, depth, seed, dropout):
    """``BertForSequenceClassification`` at BERT-base width and ``depth``
    layers whose head is a ``Linear`` with ``ParamAttr(learning_rate=
    FT_HEAD_LR)``, built in a fresh name space (as in its own process), so
    every build carries the same parameter names."""
    from paddle1_tpu_torch.text.models import (BertForSequenceClassification,
                                               BertModel)
    with paddle.utils.unique_name.guard():
        clf = BertForSequenceClassification(
            BertModel(num_hidden_layers=depth, hidden_dropout_prob=dropout,
                      attention_probs_dropout_prob=0.0,
                      generator=torch.Generator().manual_seed(seed)),
            num_classes=FT_CLASSES, dropout=dropout)
        clf.classifier = paddle.nn.Linear(
            BERT_HIDDEN, FT_CLASSES,
            weight_attr=paddle.ParamAttr(learning_rate=FT_HEAD_LR),
            generator=torch.Generator().manual_seed(seed + 1))
    return clf


def ft_warm_start(paddle, depth=None, seed=SEED + 60, dropout=0.1):
    """The user's warm start: a seeded ``BertForPretraining`` saved with
    ``paddle.save(model.state_dict(), path)`` under a temporary directory,
    loaded into a fresh classifier by ``set_state_dict(paddle.load(path))``.
    Returns the classifier, ``(missing, unexpected)`` and the pretraining
    model's keys."""
    import os
    import tempfile
    from paddle1_tpu_torch.text.models import BertForPretraining, BertModel
    depth = BERT_LAYERS if depth is None else depth
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert_pretrained.pdparams")
        with paddle.utils.unique_name.guard():
            gen = torch.Generator().manual_seed(seed)
            pre = BertForPretraining(BertModel(
                num_hidden_layers=depth, generator=gen), generator=gen)
        keys = list(pre.state_dict())
        paddle.save(pre.state_dict(), path)
        del pre
        clf = ft_classifier(paddle, depth, seed + 2, dropout)
        missing, unexpected = clf.set_state_dict(paddle.load(path))
    return clf, missing, unexpected, keys


def ft_optimizer(paddle, clf, lr=FT_LR, weight_decay=0.01, schedule=True):
    """AdamW with PaddleNLP's fine-tuning idiom: ``decay_params`` are the
    names of every parameter outside biases and norms, and
    ``apply_decay_param_fun=lambda x: x in decay_params``; the rate is a
    warm-up (a tenth of FT_DECAY_STEPS) over a polynomial decay, or
    constant. Returns ``(optimizer, scheduler or None, decay_params)``."""
    from paddle1_tpu_torch.optimizer import lr as sched
    decay_params = [p.name for n, p in clf.named_parameters()
                    if not any(nd in n for nd in ["bias", "norm"])]
    rate = sched.LinearWarmup(
        sched.PolynomialDecay(lr, decay_steps=FT_DECAY_STEPS),
        warmup_steps=FT_DECAY_STEPS // 10, start_lr=0.0, end_lr=lr) \
        if schedule else lr
    opt = paddle.optimizer.AdamW(
        learning_rate=rate, parameters=clf.parameters(),
        weight_decay=weight_decay,
        apply_decay_param_fun=lambda x: x in decay_params)
    return opt, (rate if schedule else None), decay_params


def ft_setup(paddle, batch=FT_BATCH):
    """Phase 21's fine-tuning run up to its first step (``tools/
    torch_train_profile.py --model bert_finetune`` builds it here too):
    the seeded warm start, the optimizer and the staged batches. Returns
    ``(clf, opt, sched, batches, (missing, unexpected, pre_keys,
    decay_params))``."""
    paddle.seed(SEED)
    clf, missing, unexpected, pre_keys = ft_warm_start(paddle)
    opt, sched, decay_params = ft_optimizer(paddle, clf)
    batches = ft_batches(paddle, batch, seed=SEED + 61)
    return clf, opt, sched, batches, (missing, unexpected, pre_keys,
                                      decay_params)


def ft_step_fn(paddle, clf, opt, sched, batches):
    """One eager fine-tuning step over the staged batches in turn:
    ``loss.backward(); opt.step(); sched.step(); opt.clear_grad()``."""
    F = paddle.nn.functional
    turn = [0]

    def step():
        x, y = batches[turn[0] % len(batches)]
        turn[0] += 1
        loss = F.cross_entropy(clf(x), y)
        loss.backward()
        opt.step()
        if sched is not None:
            sched.step()
        opt.clear_grad()
        return loss
    return step


def ft_one_step(paddle, clf, opt, batch, seed):
    """One step with the dropout masks drawn from ``seed``; the loss."""
    torch.manual_seed(seed)
    step = ft_step_fn(paddle, clf, opt, None, [batch])
    return float(step())


def ft_eval_loss(paddle, clf, batches):
    """The mean loss over ``batches`` in eval mode (no dropout), under
    ``no_grad``; the model goes back to training mode."""
    F = paddle.nn.functional
    clf.eval()
    with paddle.no_grad():
        losses = [float(F.cross_entropy(clf(x), y)) for x, y in batches]
    clf.train()
    return float(np.mean(losses))


def finetune_phase(dev):
    """The eighth main path: eager BERT-base fine-tuning (see the module
    docstring, phase 21)."""
    import copy
    import os
    import tempfile
    import paddle1_tpu_torch as paddle
    t0 = time.perf_counter()
    clf, opt, sched, batches, (missing, unexpected, pre_keys,
                               decay_params) = ft_setup(paddle)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(missing == ["classifier.weight", "classifier.bias"],
          f"fine-tuning warm start: missing {missing}, want exactly the "
          "classifier head's parameters")
    heads = sorted(k for k in pre_keys if not k.startswith("bert."))
    check(sorted(unexpected) == heads, f"fine-tuning warm start: "
          f"unexpected {sorted(unexpected)[:6]}..., want the pretraining "
          f"heads' {heads[:6]}...")
    enc = clf.bert.encoder
    check(len(enc.layers) == BERT_LAYERS and clf.bert.hidden_size ==
          BERT_HIDDEN and enc.layers[0].self_attn.num_heads == BERT_HEADS
          and clf.bert.vocab_size == BERT_VOCAB and
          enc.layers[0].linear1.weight.shape[1] == 3072,
          "the classifier is not BERT-base (12 x 768, 12 heads, FFN 3072)")
    check(all(p.device.type == "cuda" and p.dtype == torch.float32
              for p in clf.parameters()), "the classifier is not f32 on "
          "the card")
    check(clf.classifier.weight.optimize_attr["learning_rate"] ==
          FT_HEAD_LR, "the head's ParamAttr(learning_rate) was lost")
    n_params = sum(p.nelement() for p in clf.parameters())
    names = opt.param_names()
    check(names[0] == "embedding_0.weight" and
          not any(n.startswith("param_") for n in names),
          f"the optimizer does not see Paddle names: {names[:3]}")
    check(isinstance(batches[0][0], paddle.Tensor) and
          batches[0][0].place == paddle.CUDAPlace(dev.index or 0),
          "to_tensor did not stage the batch on the card")
    eval0 = ft_eval_loss(paddle, clf, batches)
    clf.train()
    step = ft_step_fn(paddle, clf, opt, sched, batches)
    torch.cuda.reset_peak_memory_stats()
    loss0 = float(step().numpy())
    step()
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    slopes, last, steps = timed_steps(step, FT_STEPS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(isinstance(last, paddle.Tensor), "the loss is not a Paddle Tensor")
    loss_end = float(last.numpy())
    eval_end = ft_eval_loss(paddle, clf, batches)
    check(np.isfinite(loss0) and np.isfinite(loss_end),
          f"fine-tuning: non-finite loss {loss0} / {loss_end}")
    # the loss over the staged batches in eval mode (no dropout noise)
    check(eval_end < eval0, f"fine-tuning: loss did not fall: {eval0} -> "
          f"{eval_end} (training losses {loss0} -> {loss_end})")
    want = {"flash_attention": BERT_LAYERS * steps,
            "flash_attention_bwd_dkv": BERT_LAYERS * steps,
            "flash_attention_bwd_dq": BERT_LAYERS * steps,
            "fused_adam": steps,
            "layer_norm": (2 * BERT_LAYERS + 1) * steps}
    for k, n in want.items():
        check(launches[k] == n, f"fine-tuning: {k} launched {launches[k]} "
              f"times in {steps} steps, want {n}")
    peak = torch.cuda.max_memory_allocated()
    dt = float(np.median(slopes))

    # the facade's host cost: the same loop on plain tensors (the
    # parameters are plain to every op already), in turns
    plain_batches = [(x.as_subclass(torch.Tensor), y.as_subclass(
        torch.Tensor)) for x, y in batches]
    plain_step = ft_step_fn(paddle, clf, opt, sched, plain_batches)
    check(type(plain_step()) is torch.Tensor, "the plain loop is not plain")
    facade_ms, plain_ms = [], []
    for fn, acc in ((step, facade_ms), (plain_step, plain_ms),
                    (plain_step, plain_ms), (step, facade_ms)):
        acc.append(float(np.median(timed_steps(fn, FT_HOST_STEPS)[0]))
                   * 1e3)
    prof = device_kernels_per_step(step, 2)
    busy = prof["device_busy_ms_per_step"]
    flops = (6 * n_params * FT_BATCH * FT_SEQ +
             12 * BERT_LAYERS * FT_BATCH * FT_SEQ ** 2 * BERT_HIDDEN)

    # a state_dict -> set_state_dict round trip resumes bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "finetune.pdckpt")
        paddle.save({"model": clf.state_dict(), "opt": opt.state_dict()},
                    path)
        ck = paddle.load(path)
    fresh = ft_classifier(paddle, BERT_LAYERS, SEED + 70, 0.1)
    fmissing, funexpected = fresh.set_state_dict(ck["model"])
    fopt, fsched, _ = ft_optimizer(paddle, fresh)
    fopt.set_state_dict(ck["opt"])
    del ck
    check(fmissing == [] and funexpected == [] and
          fsched.last_epoch == sched.last_epoch,
          f"resume: missing {fmissing}, unexpected {funexpected}, "
          f"schedule at {fsched.last_epoch} vs {sched.last_epoch}")
    fresh.train()
    on = ft_one_step(paddle, clf, opt, batches[0], SEED + 71)
    resumed = ft_one_step(paddle, fresh, fopt, batches[0], SEED + 71)
    resume_equal = on == resumed and all(
        torch.equal(a, b) for a, b in zip(clf.parameters(),
                                          fresh.parameters()))
    check(resume_equal, f"fine-tuning: a step after save/load differs from "
          f"the uninterrupted run: {on} vs {resumed}")
    del fresh, fopt

    # one step with decay against the same step without: the parameters
    # the filter excludes (biases, norms) are equal bit for bit
    twin = copy.deepcopy(clf)
    d_opt, _, _ = ft_optimizer(paddle, clf, schedule=False)
    n_opt, _, _ = ft_optimizer(paddle, twin, weight_decay=0.0,
                               schedule=False)
    ft_one_step(paddle, clf, d_opt, batches[1], SEED + 72)
    ft_one_step(paddle, twin, n_opt, batches[1], SEED + 72)
    excluded, moved = [], 0
    for (n, p), q in zip(clf.named_parameters(), twin.parameters()):
        if p.name in decay_params:
            moved += not torch.equal(p, q)
        else:
            excluded.append((n, torch.equal(p, q)))
    check(excluded and all(eq for _, eq in excluded),
          f"fine-tuning: a parameter the filter excludes was decayed: "
          f"{[n for n, eq in excluded if not eq][:4]}")
    check(moved > 0, "fine-tuning: weight decay moved no parameter")
    check(all(n.endswith(".bias") or "norm" in n for n, _ in excluded),
          "fine-tuning: the filter excluded a weight")
    del twin, d_opt, n_opt

    summary = {
        "train": "bert_base_finetune_eager", "dtype": "float32",
        "tf32": False, "batch": FT_BATCH, "seq_len": FT_SEQ,
        "layers": BERT_LAYERS, "params": n_params, "lr": FT_LR,
        "head_lr_ratio": FT_HEAD_LR, "init_s": init_s,
        "warm_start": {"missing": missing, "unexpected": len(unexpected)},
        "decay_params": len(set(decay_params)),
        "not_decayed": len(excluded), "decayed_moved": moved,
        "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3,
        "samples_per_s": FT_BATCH / dt, "tokens_per_s": FT_BATCH * FT_SEQ /
        dt, "flops_per_step": flops,
        # TF32 is off (main sets it): f32 products on the CUDA cores
        "mfu": flops / dt / F32_FLOPS_PER_S, "mfu_peak": "f32 67 TFLOP/s",
        "loss_first": loss0, "loss_last": loss_end,
        "eval_loss_before": eval0, "eval_loss_after": eval_end,
        "peak_mem_gb": peak / 1e9, "peak_mem_gib": peak / 2 ** 30,
        "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "step_ms_facade_runs": facade_ms, "step_ms_plain_runs": plain_ms,
        "facade_host_ms_per_step": float(np.median(facade_ms)) -
        float(np.median(plain_ms)),
        "device_idle_share": 1.0 - busy / (dt * 1e3),
        "profiler_window_idle_share": 1.0 - busy / prof["profiled_step_ms"],
        "resume_loss": [on, resumed], "resume_bit_identical": resume_equal,
        "profile": prof}
    log(json.dumps({"bert_finetune": summary}))
    del clf, opt, batches, plain_batches
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 22: the fine-tuning reference check


def finetune_reference_check(dev):
    """Depth 2, batch FT_REF_BATCH x FT_SEQ (ragged padding), f32, dropout
    0: REF_STEPS eager fine-tuning steps (warm start, decay filter, head
    rate, schedule) on the kernel path against the plain path (every
    kernel flag ``never``) from identical weights: losses and parameters
    within REF_TOL, the attention key biases within REF_STEPS x lr (as
    phase 7)."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.core.flags import flags_guard
    batches = ft_batches(paddle, FT_REF_BATCH, n=1, seed=SEED + 80)
    counters = train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    runs = {}
    for path, flags in (("kernel", {}),
                        ("plain", dict(flash_attention="never",
                                       flash_backward="never",
                                       fused_adam="never",
                                       fused_layer_norm="never"))):
        with flags_guard(**flags):
            clf, _, _, _ = ft_warm_start(paddle, FT_REF_DEPTH, SEED + 81,
                                         0.0)
            opt, sched, _ = ft_optimizer(paddle, clf)
            for _ in range(FT_DECAY_STEPS // 10):   # past the warm-up
                sched.step()
            step = ft_step_fn(paddle, clf, opt, sched, batches)
            mark = {k: fn.launches for k, fn in counters.items()}
            losses = [float(step()) for _ in range(REF_STEPS)]
            torch.cuda.synchronize()
            runs[path] = (clf, losses, {k: fn.launches - mark[k]
                                        for k, fn in counters.items()})
    (mk, lk, nk), (mp, lp, np_) = runs["kernel"], runs["plain"]
    check(all(n > 0 for n in nk.values()), f"the kernel path skipped a "
          f"kernel: {nk}")
    check(all(n == 0 for n in np_.values()), f"the plain path launched a "
          f"kernel: {np_}")
    loss_err = max(abs(a - c) for a, c in zip(lk, lp))
    sk, sp = mk.state_dict(), mp.state_dict()
    param_err, key_bias_err = 0.0, 0.0
    for k in sk:
        e = float((sk[k] - sp[k]).abs().max())
        if k.endswith("k_proj.bias"):
            key_bias_err = max(key_bias_err, e)
        else:
            param_err = max(param_err, e)
    for k in counters:
        counters[k].launches = before[k]
    out = {"finetune_reference": {
        "depth": FT_REF_DEPTH, "dtype": "float32", "batch": FT_REF_BATCH,
        "seq_len": FT_SEQ, "steps": REF_STEPS, "losses_kernel": lk,
        "losses_plain": lp, "max_loss_err": loss_err,
        "max_param_err": param_err, "max_key_bias_err": key_bias_err,
        "kernel_launches": nk}}
    log(json.dumps(out))
    check(lk[-1] < lk[0], f"fine-tuning reference: loss did not fall {lk}")
    check(loss_err <= REF_TOL, f"fine-tuning reference: losses differ by "
          f"{loss_err}: {lk} vs {lp}")
    check(param_err <= REF_TOL, f"fine-tuning reference: params differ by "
          f"{param_err}")
    check(key_bias_err <= REF_STEPS * FT_LR, f"fine-tuning reference: key "
          f"biases differ by {key_bias_err} > {REF_STEPS * FT_LR}")
    del runs, mk, mp
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 23: the op namespace on the card

# the card's libraries (libdevice, cuBLAS, cuSOLVER) against the CPU's: ten
# times each case's CPU tolerance, at least 1e-5
OPS_TOL_SCALE, OPS_TOL_MIN = 10.0, 1e-5
CARD = "cuda"      # the device type every output must be on


def op_cases():
    """``tests/test_torch_op_cases.py`` (no JAX), loaded by path."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_op_cases.py")
    spec = importlib.util.spec_from_file_location("test_torch_op_cases", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


def op_tensors(paddle, v, grad):
    if isinstance(v, np.ndarray):
        return paddle.to_tensor(v, stop_gradient=not grad)
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [op_tensors(paddle, e, grad) for e in v]
    return v


def op_run(paddle, cases, case, fn, place):
    """``fn(*args, **kw)`` with the case's arrays made Paddle tensors on
    ``place``: ``(output, gradients, in-place arguments after)``."""
    with paddle.device_guard(place):
        args = [op_tensors(paddle, a, i in case.grad)
                for i, a in enumerate(case.args)]
        out = fn(*args, **case.kw)
        grads = []
        if case.grad:
            first = out[0] if isinstance(out, (tuple, list)) else out
            w = cases.R(tuple(first.shape), 99)
            (first * paddle.to_tensor(w)).sum().backward()
            grads = [args[i].grad for i in case.grad]
        return out, grads, [args[i] for i in case.after]


def op_leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in op_leaves(o)]
    return [out]


def op_compare(cases, want, got, tol):
    """``got`` (the card's) against ``want`` (the CPU's): the same
    structure, every tensor of ``got`` on the card, dtypes and shapes
    equal, values within ``tol``."""
    w, g = op_leaves(want), op_leaves(got)
    check(len(w) == len(g), f"{len(g)} outputs, the CPU gave {len(w)}")
    for a, b in zip(w, g):
        if not isinstance(a, torch.Tensor):
            check(a == b, f"{b!r} vs the CPU's {a!r}")
            continue
        check(isinstance(b, torch.Tensor) and b.device.type == CARD,
              f"an output is not on the card: {getattr(b, 'device', b)}")
        check(a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape),
              f"{b.dtype} {tuple(b.shape)} vs the CPU's {a.dtype} "
              f"{tuple(a.shape)}")
        x, y = cases.np_of(a), cases.np_of(b)
        if x.dtype.kind in "fc":
            np.testing.assert_allclose(y, x, rtol=tol, atol=tol,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(y, x)


def ops_phase(dev):
    """Phase 23 (the module docstring): every op case on the card against
    the CPU, ``matmul_int8`` at ``_int_mm``'s rules, the random ops."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.core.errors import InvalidArgumentError
    from paddle1_tpu_torch.ops import linalg_ops, manip_ops, math_ops
    cases = op_cases()
    card = f"gpu:{dev.index or 0}"
    groups = (("math_ops", math_ops, cases.math_cases()),
              ("manip_ops", manip_ops, cases.manip_cases()),
              ("linalg_ops", linalg_ops, cases.linalg_cases()),
              ("Tensor", None, cases.method_cases()))
    failed, n_cases, names = [], 0, set()
    t0 = time.perf_counter()
    for group, mod, group_cases in groups:
        for case in group_cases:
            fn = cases.method(case.op) if mod is None else \
                getattr(mod, case.op)
            tol = max(case.tol * OPS_TOL_SCALE, OPS_TOL_MIN)
            n_cases += 1
            names.add(f"{group}.{case.op}")
            try:
                want = op_run(paddle, cases, case, fn, "cpu")
                got = op_run(paddle, cases, case, fn, card)
                if case.check is not None:
                    case.check(want[0], got[0])
                    op_compare(cases, [t for t in op_leaves(want[0])
                                       if not isinstance(t, torch.Tensor)],
                               [t for t in op_leaves(got[0])
                                if not isinstance(t, torch.Tensor)], tol)
                    check(all(t.device.type == CARD for t in
                              op_leaves(got[0])
                              if isinstance(t, torch.Tensor)),
                          "an output is not on the card")
                else:
                    op_compare(cases, want[0], got[0], tol)
                op_compare(cases, want[1], got[1], tol)
                op_compare(cases, want[2], got[2], tol)
            except Exception as e:   # noqa: BLE001  (every failure listed)
                failed.append(f"{group}.{case.name()}: {type(e).__name__}: "
                              f"{str(e).strip()[:300]}")
    ported = {f"{m.__name__.rsplit('.', 1)[1]}.{n}"
              for m in (math_ops, manip_ops, linalg_ops) for n in m.__all__}
    random_names = {f"manip_ops.{r[0]}" for r in cases.RANDOM}
    uncovered = sorted(ported - names - random_names)
    if uncovered:
        failed.append(f"ops without a case on the card: {uncovered}")

    # matmul_int8 at torch._int_mm's rules and outside them
    rng = np.random.default_rng(SEED + 90)
    a = rng.integers(-100, 100, (32, 64)).astype(np.int8)
    b = rng.integers(-100, 100, (64, 16)).astype(np.int8)
    try:
        want = math_ops.matmul_int8(paddle.to_tensor(a, place="cpu"),
                                    paddle.to_tensor(b, place="cpu"))
        got = math_ops.matmul_int8(paddle.to_tensor(a), paddle.to_tensor(b))
        check(got.dtype == torch.int32 and got.device.type == CARD and
              torch.equal(got.cpu(), want.as_subclass(torch.Tensor)),
              "matmul_int8 inside _int_mm's rules differs from the CPU")
        for x, y in ((a[:8], b), (a[:, :60], b[:60]), (a, b[:, :12])):
            try:
                math_ops.matmul_int8(paddle.to_tensor(x), paddle.to_tensor(y))
                check(False, f"matmul_int8 {x.shape} x {y.shape} outside "
                      "_int_mm's rules did not raise")
            except InvalidArgumentError:
                pass
    except Exception as e:   # noqa: BLE001
        failed.append(f"matmul_int8: {type(e).__name__}: {str(e)[:300]}")

    # the random ops on the card: shape, dtype, support, seeded repeats
    class Ns:
        def __getattr__(self, name):
            return paddle.to_tensor if name == "to_tensor" else \
                getattr(manip_ops, name)
    ns = Ns()
    for name, draw, support, _ in cases.RANDOM:
        try:
            paddle.seed(SEED + 91)
            first = draw(ns)
            paddle.seed(SEED + 91)
            again = draw(ns)
            g1 = torch.Generator(dev).manual_seed(5)
            g2 = torch.Generator(dev).manual_seed(5)
            check(first.device.type == CARD and first.numel_() > 0,
                  f"{name} did not draw on the card")
            check(torch.equal(first, again), f"{name} does not repeat "
                  "under paddle.seed")
            check(torch.equal(draw(ns, generator=g1),
                              draw(ns, generator=g2)),
                  f"{name} does not repeat under a generator")
            v = first.numpy().astype(np.float64)
            if support is not None:
                check(v.min() >= support[0] and v.max() <= support[1],
                      f"{name} outside its support {support}")
        except Exception as e:   # noqa: BLE001
            failed.append(f"random {name}: {type(e).__name__}: "
                          f"{str(e)[:300]}")
    torch.cuda.synchronize()
    out = {"op_namespace": {
        "ops": len(names | random_names), "cases": n_cases,
        "random_ops": len(cases.RANDOM), "matmul_int8_rules": 3,
        "seconds": time.perf_counter() - t0, "failed": failed}}
    log(json.dumps(out))
    check(not failed, f"the op namespace failed {len(failed)} checks on "
          f"the card: {failed[:5]}")
    return out


# ---------------------------------------------------------------------------
# phase 24: BERT-base fine-tuning evaluated in Paddle idiom

FT_EVAL_BATCHES, FT_EVAL_TRAIN_STEPS, FT_SPLIT_TOL = 4, 10, 1e-4


def finetune_eval_phase(dev):
    """Phase 24 (the module docstring)."""
    import paddle1_tpu_torch as paddle
    paddle.seed(SEED + 100)
    clf, _, _, _ = ft_warm_start(paddle, seed=SEED + 101)
    opt, sched, _ = ft_optimizer(paddle, clf)
    train = ft_batches(paddle, FT_BATCH, seed=SEED + 102)
    step = ft_step_fn(paddle, clf, opt, sched, train)
    for _ in range(FT_EVAL_TRAIN_STEPS):
        step()
    batches = ft_batches(paddle, FT_BATCH, n=FT_EVAL_BATCHES,
                         seed=SEED + 103)
    clf.eval()
    counters = train_counters()
    with paddle.no_grad():
        clf(batches[0][0])                      # warm
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits, labels, accs = [], [], []
        for x, y in batches:
            out = clf(x)
            pred = paddle.argmax(out, axis=-1)
            accs.append(paddle.equal(pred, y).astype("float32").mean())
            logits.append(out)
            labels.append(y)
        every = paddle.concat(logits, axis=0)
        acc = paddle.equal(paddle.argmax(every, axis=-1),
                           paddle.concat(labels)).astype("float32").mean()
        acc_value = float(acc)
        eval_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        launches = {k: fn.launches for k, fn in counters.items()}
        x, _ = batches[0]
        halves = x.split(2, 0)
        joined = paddle.concat([clf(h) for h in halves], axis=0)
        whole = clf(x)
    torch.cuda.synchronize()
    check(all(isinstance(t, paddle.Tensor) and t.device.type == CARD
              for t in (every, acc, joined, whole) + tuple(accs)),
          "the namespace's outputs are not Paddle tensors on the card")
    check(every.shape == [FT_BATCH * len(batches), FT_CLASSES] and
          acc.shape == [] and acc.dtype == torch.float32,
          f"eval shapes: logits {every.shape}, accuracy {acc.shape} "
          f"{acc.dtype}")
    check(len(halves) == 2 and all(h.shape == [FT_BATCH // 2, FT_SEQ]
                                   for h in halves),
          f"x.split(2, 0) gave {[h.shape for h in halves]}, want two "
          f"halves of {FT_BATCH // 2}")
    split_err = float((joined - whole).abs().max())
    check(split_err <= FT_SPLIT_TOL, f"the halves' logits differ from the "
          f"whole batch's by {split_err}")
    mean_of_batches = float(paddle.concat([a.reshape([1]) for a in accs])
                            .mean())
    check(abs(mean_of_batches - acc_value) < 1e-6, f"per-batch accuracies "
          f"{mean_of_batches} vs over the concat {acc_value}")
    n = len(batches)
    want = {"layer_norm": (2 * BERT_LAYERS + 1) * n,
            "flash_attention": BERT_LAYERS * n,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "fused_adam": 0}
    for k, v in want.items():
        check(launches[k] == v, f"fine-tuning eval: {k} launched "
              f"{launches[k]} times over {n} batches, want {v}")
    out = {"bert_finetune_eval": {
        "batches": n, "batch": FT_BATCH, "seq_len": FT_SEQ,
        "train_steps_before": FT_EVAL_TRAIN_STEPS, "accuracy": acc_value,
        "batch_accuracies": [float(a) for a in accs],
        "eval_ms_per_batch": eval_ms, "launches": launches,
        "split_halves": [h.shape for h in halves],
        "split_max_abs_err": split_err}}
    log(json.dumps(out))
    del clf, opt, train, batches
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 2
    from paddle1_tpu_torch.core.device import resolve_device
    from paddle1_tpu_torch.ops.cuda import build
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls stay f32
    torch.backends.cudnn.allow_tf32 = False
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name in build.SOURCES:
        report = build.build_log(name) or ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    tc_report = tensor_core_report(build, libs)
    bn_regs = bn_register_report(build)

    kernels = kernel_phase(dev)
    lm, eng, reqs, outs, launches, steps = serving_phase(dev)

    greedy = [i for i, (_, kw) in enumerate(reqs)
              if not kw.get("temperature")]
    pick = max(greedy, key=lambda i: len(outs[i]))
    err, n = teacher_forced_check(lm, eng, reqs[pick][0], outs[pick], dev)
    log(json.dumps({"teacher_forced": {"request": pick, "steps": n,
                                       "max_abs_logit_err": err}}))
    state = {k: v for k, v in lm.state_dict().items()}
    del eng
    log(json.dumps(dense_check(state, dev)))
    del lm, state
    torch.cuda.empty_cache()

    flash_errs = flash_check(dev)
    flash_t, flash_b, flash_shape = flash_timing(dev)
    flash_te, flash_be, flash_shape_e = flash_timing(dev, ERNIE_ATTN)
    flash_tf, flash_bf, flash_shape_f = flash_timing(
        dev, FT_ATTN, torch.float32, ragged=True)
    adam = adam_phase(dev)
    ln_train = train_layer_norm_case(dev)
    ln_ernie = [train_layer_norm_case(dev, ERNIE_BATCH * ERNIE_SEQ,
                                      ERNIE_HIDDEN, dt)
                for dt in (torch.bfloat16, torch.float32)]
    ln_ft = train_layer_norm_case(dev, FT_BATCH * FT_SEQ, BERT_HIDDEN,
                                  torch.float32)
    kernels["layer_norm"] += [ln_train] + ln_ernie + [ln_ft]
    torch.cuda.empty_cache()
    train = train_phase(dev)
    torch.cuda.empty_cache()
    train_reference_check(dev)
    torch.cuda.empty_cache()

    bn_errs = bn_check(dev)
    bn_times = bn_timing(dev)
    rn = resnet_phase(dev)
    torch.cuda.empty_cache()
    resnet_reference_check(dev)
    torch.cuda.empty_cache()

    mom_errs, mom_times = moments_phase(dev)
    dp = resnet_dp_phase(dev, rn)
    torch.cuda.empty_cache()
    cross_rank_check(dev)

    sm_errs, sm_times, sm_grad_err = softmax_phase(dev)
    lenet = lenet_phase(dev)
    lenet_reference_check(dev)
    torch.cuda.empty_cache()

    yolo_bn_errs, yolo_bn_times = yolo_bn_phase(dev)
    yolo = yolo_phase(dev)
    yolo_reference_check(dev)
    torch.cuda.empty_cache()

    adam_e = adam_ernie_phase(dev)
    ernie = ernie_phase(dev)
    ernie_reference_check(dev)
    torch.cuda.empty_cache()

    ft = finetune_phase(dev)
    finetune_reference_check(dev)
    torch.cuda.empty_cache()

    ops_phase(dev)
    fte = finetune_eval_phase(dev)["bert_finetune_eval"]["launches"]

    src = "paddle1_tpu_torch/ops/cuda/"
    pallas = "paddle1_tpu/ops/pallas/"
    tl = train["launches"]
    line = []
    for name in ("paged_attention", "layer_norm"):
        main_case = kernels[name][0]     # the decode step's shape
        err = max(c["max_abs_err"] for c in kernels[name])
        by_path = {"serving": launches[name], "train": tl.get(name, 0),
                   "ernie": ernie["launches"].get(name, 0),
                   "bert_finetune": ft["launches"].get(name, 0),
                   "bert_finetune_eval": fte.get(name, 0)}
        line.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": {"paged_attention": pallas + "paged_attention.py:89",
                         "layer_norm": pallas + "layer_norm.py:42"}[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "launches_per_decode_step": {"paged_attention": LAYERS,
                                         "layer_norm": 2 * LAYERS}[name],
            "decode_steps": steps, "cases": kernels[name],
            "bf16_check": kernels[name + "_bf16"]})
    # the training path's shape (BERT-base, bf16 [16384, 768])
    line[-1].update({f"train_shape_{k}": ln_train[k] for k in (
        "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")})
    line[-1]["train_shape"] = ln_train["shape"]
    # ERNIE-1.5B's (bf16 [2048, 2304], the block-per-row kernel; f32 in
    # ernie_f32_case)
    line[-1].update({f"ernie_shape_{k}": ln_ernie[0][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")})
    line[-1]["ernie_shape"] = ln_ernie[0]["shape"]
    line[-1]["ernie_f32_case"] = ln_ernie[1]
    line[-1]["launches_per_ernie_forward"] = 2 * ERNIE_LAYERS + 2
    # the fine-tuning path's (f32 [4096, 768])
    line[-1].update({f"bert_finetune_shape_{k}": ln_ft[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")})
    line[-1]["bert_finetune_shape"] = ln_ft["shape"]
    line[-1]["launches_per_bert_finetune_forward"] = 2 * BERT_LAYERS + 1
    flash_rows = (
        ("flash_attention", "flash_attention.cu",
         pallas + "flash_attention.py:59", "fwd", "fwd_plain",
         "fwd_library", "flash_fwd_tc_kernel"),
        ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
         pallas + "flash_attention_bwd.py:74", "dkv", "bwd_plain",
         "bwd_library", "flash_bwd_dkv_tc_kernel"),
        ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
         pallas + "flash_attention_bwd.py:125", "dq", "bwd_plain",
         "bwd_library", "flash_bwd_dq_tc_kernel"))
    designs = {
        "fwd": "bf16: mma.sync m16n8k16 on the tensor cores, 4 warps x 16 "
               "query rows per CTA, Q in registers, K/V 64-key tiles "
               "double-buffered by cp.async, online softmax in registers, "
               "P V from the S accumulators with P split bf16 hi + lo; f32: "
               "CUDA-core kernel",
        "dkv": "bf16: mma.sync m16n8k16 on the tensor cores, 4 warps x 16 "
               "keys per CTA, K/V A fragments resident, Q/dO 64-query tiles "
               "double-buffered by cp.async, S^T/dP^T/P^T/dS^T in "
               "registers per 32-query sub-tile, P^T and dS^T split bf16 "
               "hi + lo; f32: CUDA-core kernel",
        "dq": "bf16: mma.sync m16n8k16 on the tensor cores, 8 warps x 16 "
              "queries per CTA at D = 64, Q/dO rows resident in shared "
              "memory, K/V 64-key tiles double-buffered by cp.async, "
              "lse/delta in registers, S/dP/dS in registers per 64-key "
              "tile, dS split bf16 hi + lo; f32: CUDA-core kernel"}
    for name, cu, rep, key, plain_key, lib_key, tc in flash_rows:
        by_path = {"train": tl[name], "ernie": ernie["launches"][name],
                   "bert_finetune": ft["launches"][name],
                   "bert_finetune_eval": fte[name]}
        line.append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": rep, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in flash_errs[key]),
            "ms": flash_t[key], "plain_ms": flash_t[plain_key],
            "bound_ms": flash_b[key][0], "bound_by": flash_b[key][1],
            "library_ms": flash_t[lib_key], "shape": flash_shape,
            "plain_covers": "one call" if key == "fwd" else
            "dq, dk and dv together",
            "library_covers": "sdpa forward (graph replay)" if key == "fwd"
            else "sdpa backward alone (dq, dk, dv): forward + backward less "
                 "forward, both by graph replay",
            "library_ops": flash_t["library_backend"],
            "library_fwd_bwd_eager_ms": flash_t["fwd_bwd_library_eager"],
            "design": designs[key],
            "sass": tc_report.get(tc) if tc else None,
            "ernie_shape": flash_shape_e, "ernie_shape_ms": flash_te[key],
            "ernie_shape_plain_ms": flash_te[plain_key],
            "ernie_shape_bound_ms": flash_be[key][0],
            "ernie_shape_bound_by": flash_be[key][1],
            "ernie_shape_library_ms": flash_te[lib_key],
            "ernie_shape_library_ops": flash_te["library_backend"],
            "bert_finetune_shape": flash_shape_f,
            "bert_finetune_shape_ms": flash_tf[key],
            "bert_finetune_shape_plain_ms": flash_tf[plain_key],
            "bert_finetune_shape_bound_ms": flash_bf[key][0],
            "bert_finetune_shape_bound_by": flash_bf[key][1],
            "bert_finetune_shape_library_ms": flash_tf[lib_key],
            "cases": flash_errs[key]})
    by_path = {"train": tl["fused_adam"],
               "lenet_train": lenet["launches"]["fused_adam"],
               "ernie": ernie["launches"]["fused_adam"],
               "bert_finetune": ft["launches"]["fused_adam"]}
    line.append({
        "name": "fused_adam", "route": "cuda", "source": src + "fused_adam.cu",
        "replaces": pallas + "fused_adam.py:39",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max([c["max_abs_err"] for c in adam["cases"]] +
                           [adam_e["max_abs_err"],
                            adam_e["max_abs_err_bf16"]]),
        "ms": adam["ms"], "ms_mixed_lr_scales": adam["ms_mixed_lr_scales"],
        "f32": adam["f32"], "bf16": adam["bf16"],
        "plain_ms": adam["plain_ms"],
        "bound_ms": adam["bound_ms"], "bound_by": adam["bound_by"],
        "library_ms": adam["library_ms"], "tensors": adam["tensors"],
        "elements": adam["elements"], "cases": adam["cases"],
        "ernie_scale": adam_e})
    bn_rows = (("fused_bn_train", "fused_bn.cu", "fused_bn.py:90",
                ("train_fwd_kernel",)),
               ("fused_bn_norm", "fused_bn.cu", "fused_bn.py:245",
                ("normalize_kernel",)),
               ("fused_bn_train_bwd", "fused_bn_bwd.cu",
                "fused_bn_bwd.py:54", ("train_bwd_kernel",)),
               ("fused_bn_norm_bwd", "fused_bn_bwd.cu",
                "fused_bn_bwd.py:158", ("norm_bwd_kernel",)))

    def layer4(case):
        """The layer-4 ([1568, 2048]) times of one timing list."""
        c4, = [t for t in case if t["shape"] == BN_LAYER4]
        return {f"layer4_{k}": c4[k] for k in ("ms", "plain_ms",
                                               "library_ms", "bound_ms")}
    for name, cu, rep, pieces in bn_rows:
        by_path = {"resnet_train": rn["launches_train"][name],
                   "resnet_eval": rn["launches_eval"][name],
                   "resnet_frozen": rn["launches_frozen"][name],
                   "resnet_dp": dp["launches_train"][name],
                   "yolov3": yolo["launches"][name]}
        main_case = bn_times[name][0]     # the stem's [401408, 64]
        line.append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": pallas + rep, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in bn_errs[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "library_covers": main_case["library_covers"],
            "shape": [main_case["shape"], "bf16", "identity, no residual"],
            **layer4(bn_times[name]),
            "registers": {p: bn_regs[f"{cu[:-3]}.{p}"] for p in pieces},
            "timing_cases": bn_times[name], "cases": bn_errs[name]})
        if name == "fused_bn_norm":
            line[-1].update({
                "max_abs_err": max([line[-1]["max_abs_err"]] + [
                    c["max_abs_err"] for c in yolo_bn_errs]),
                "yolov3_launches_per_forward":
                    yolo["launches_per_forward"][name],
                "yolov3_timing_cases": yolo_bn_times,
                "yolov3_cases": yolo_bn_errs})
    main_case = mom_times[0]     # the stem's [401408, 64]
    n_mom = dp["launches_train"]["fused_bn_moments"]
    line.append({
        "name": "fused_bn_moments", "route": "cuda",
        "source": src + "fused_bn.cu", "replaces": pallas + "fused_bn.py:357",
        "launches": n_mom, "launches_by_path": {"resnet_dp": n_mom},
        "max_abs_err": max(c["max_abs_err"] for c in mom_errs),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "library_covers": main_case["library_covers"],
        "shape": [main_case["shape"], "bf16"], **layer4(mom_times),
        "registers": {"moments_kernel":
                      bn_regs["fused_bn.moments_kernel"]},
        "timing_cases": mom_times, "cases": mom_errs})
    main_case = sm_times[0]     # LeNet's prediction, [64, 10]
    n_sm = lenet["predict_launches"]["softmax"]
    line.append({
        "name": "softmax", "route": "cuda", "source": src + "softmax.cu",
        "replaces": pallas + "softmax.py:40", "launches": n_sm,
        "launches_by_path": {"lenet_predict": n_sm},
        "max_abs_err": max(c["max_abs_err"] for c in sm_errs),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "library_covers": main_case["library_covers"],
        "shape": [main_case["shape"], "bf16"], "timing_cases": sm_times,
        "autograd_max_abs_err": sm_grad_err, "cases": sm_errs})
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
