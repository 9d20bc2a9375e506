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
    at batch 128), ``[2048, 32000]`` (the serving vocabulary), the
    ragged ``[1000, 1003]``, ``[4096, 30522]`` (BERT-base's masked-LM
    logits at a fine-tuning batch of 32 x 128) and ``[2048, 32769]`` (one
    element past the kernel's on-chip limit, its two-pass path), in f32
    (1e-6 abs), bf16 and f16 (one rounding step), half of one row masked
    to -inf, repeats bit-identical; its autograd gradient against plain
    autograd (1e-6, f32); timed in bf16 and f32 beside its plain version,
    ``torch.softmax`` and its bound.
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
25. **Rows 3-6 in float16.** The flash forward, dK/dV and dQ passes in
    float16 (the f16 form of the tensor-core product) against their plain
    versions at the fine-tuning shape ``[32, 128, 12, 64]`` with its
    ragged ``[B, Nk]`` keep-mask (also causal) and ERNIE-1.5B's ``[4,
    512, 18, 128]``: one f16 rounding step beyond FLASH_BF16_ABS on the
    outputs and on dQ/dK/dV, LSE to 1e-5, the fully padded row zero,
    repeats bit for bit; timed at both shapes by graph replay beside
    their plain versions, ``sdpa`` in float16 and their bounds. The fused
    AdamW kernel on float16 parameters (f32 moments) over BERT-base's
    110 M parameters, aligned, with mixed scales and on views at odd
    offsets, against its plain version (Adam's tolerance); timed in
    alternating rounds of graph replays beside
    ``torch.optim.AdamW(fused=True, capturable=True)`` on the same
    float16 parameters, its plain version and its bound.
26. **BERT-base fine-tuning under AMP O1 (the ninth main path).** Phase
    21's cell (warm start, batches, optimizer) under
    ``paddle.amp.auto_cast()``: the step-1 loss within 2e-2 relative of
    the f32 path's on the same weights, batch and dropout masks; three
    bf16 steps with the counters zeroed just before and read just after
    (12 flash forward, dK/dV and dQ launches a step on bf16 q, 25
    LayerNorm launches a forward in f32, one fused AdamW a step on the
    f32 parameters), every gradient f32; then steps under
    ``auto_cast(dtype="float16")`` with ``GradScaler(
    init_loss_scaling=2**40)``: each overflowing step skipped with every
    parameter and Adam moment bit-equal to before and the scale halved,
    until a step applies; three more with the counters zeroed (flash in
    float16, one AdamW an applied step), losses finite. Each dtype's step
    timed by slope+readback as phase 21, two more under ``torch.profiler``
    for the device's busy time and idle share; prints step ms, samples/s
    and MFU over 989 TFLOP/s beside phase 21's f32 step, and the count of
    skipped steps.
27. **O2 (pure low precision).** ``paddle.amp.decorate(clf, opt,
    level="O2", dtype=...)`` on a fresh warm start, for bfloat16 and for
    float16 (with ``GradScaler()``): the parameters in the dtype, three
    steps under ``auto_cast(level="O2")`` with the counters zeroed (flash
    in the dtype, fused AdamW on the dtype's parameters with f32
    moments), losses finite; timed as phase 26; a ``save`` -> ``load`` of
    model, optimizer and ``scaler.state_dict()`` into a fresh decorated
    classifier repeats the next step bit for bit.
28. **The nn slice on the card.** Every case of
    ``tests/test_torch_nn_cases.py`` (each name of the JAX package's
    activation, norm, loss, common, pooling and CRF functionals and of its
    norm, activation, loss, common, pooling and recurrent layers: the
    kinks, every reduction, the affine-less batch norms of F18 on rows 8,
    9 and 11, ``return_mask`` on tied windows, cuDNN's LSTM / GRU / RNN
    against the CPU's) on CUDA Paddle tensors against the same call on CPU
    Paddle tensors at 10x the case's CPU tolerance (at least 1e-5):
    values, dtypes, the gradients of the listed inputs and of a layer's
    parameters, its buffers after the call, every output on the card;
    ``rrelu`` and ``gumbel_softmax`` drawn on the card by distribution and
    repeated under a CUDA ``generator``; and three steps of each optimizer
    the port added (``SGD``, ``Lars``, ``Ftrl``, ``Adagrad``, ``Adamax``,
    ``AdaDelta``/``Adadelta``, ``RMSProp``, ``Lamb``: weight decay, a
    global-norm clip, a ``StepDecay`` schedule) on the card against the
    CPU at 10x the CPU tests' 1e-5. Prints one line ``nn_cases`` with
    every failure.
29. **MobileNetV2 ImageNet training and eval (the tenth main path).**
    ``paddle.vision.models.mobilenet_v2()`` (3,504,872 parameters, 52
    batch norms at 13 widths, seeded weights) at Sandler et al. 2018's
    batch of 96 x 3 x 224², f32 with TF32 off, two seeded batches staged
    on the card: ``nn.CrossEntropyLoss()(model(x), y)``,
    ``loss.backward()``, ``opt.step()``, ``opt.clear_grad()`` with
    ``optimizer.Momentum(0.045, 0.9, weight_decay=L2Decay(4e-5))`` (the
    paper's RMSProp is not ported); two warm-up steps, then slope+readback
    timing with the counters zeroed just before and read just after: 52
    row-8 and 52 row-11 launches a step; two more under
    ``torch.profiler`` for the device's busy time, idle share and the
    batch-norm kernels' share of it; the loss finite and falling. Then
    ``model.eval()``: a forward with 52 row-9 launches and the top-1
    through ``F.softmax`` (one row-7 launch at ``[96, 1000]``), timed; a
    ``save`` -> ``load`` into a fresh model gives the same eval logits bit
    for bit; three bf16 steps of the same model through
    ``ParallelEngine(..., amp_dtype="bfloat16")`` (52 + 52 launches
    each). Rows 8, 9, 11 (and 12) against their plain versions at the 19
    ``[rows, C]`` shapes the path gives them, f32 and bf16, repeats bit
    for bit; timed in f32 at four of them beside their plain versions,
    ``F.batch_norm`` and their bounds. Then the f32 kernel path against
    the plain path by ResNet-50's checks: at full depth, batch 16 x 224²,
    the first step's losses within 1e-4 and its gradients no farther
    from float64 than twice the plain path's (worst and median); cut to
    the first block of each stage at batch 32 x 64², three eager Momentum
    steps within 1e-4, and at four seeds the first step's gradients
    within 1e-3 of the plain path's, both taken on float64's side of each
    ReLU6 kink (``mobilenet_reference_check``). Prints step ms, images/s,
    busy ms, idle share, eval forward ms and peak memory beside the
    card's name and power limit.
30. **Transformer-base training (the eleventh main path).** First rows
    3-5 alone, held to their plain versions and repeated bit for bit at
    the path's three attention shapes (bf16, ragged keep-masks): the
    cross-attention (the target's 128 queries against the 256 bucket's
    sources, ``[16, N, 8, 64]``) and the two buckets' encoder
    self-attentions (``[32, 128, 8, 64]``, ``[16, 256, 8, 64]``); timed at
    the cross-attention shape beside their plain versions, ``sdpa``'s
    forward and backward and their bounds; row 2
    timed at its f32 ``[4096, 512]``. Then the user script below
    (``s2s_model``: ``nn.Transformer(512, 8, 6, 6, 2048, dropout=0.1,
    attn_dropout=0, act_dropout=0)``, post-norm, between one shared
    ``nn.Embedding(37000, 512, padding_idx=0)`` scaled by sqrt(512) with
    sinusoidal positions and the tied output projection
    ``paddle.matmul(h, emb.weight, transpose_y=True)``; 63,082,496
    seeded parameters) trains eagerly under ``amp.auto_cast()`` (bf16
    O1; LayerNorm black-listed, so row 2 runs in f32) on two seeded
    token buckets cycled, 32 x (source 128, target 128) and 16 x (256,
    128), ragged lengths padded to multiples of 128 (the flash kernels
    take no ragged tail), with ``F.label_smooth(F.one_hot(y, 37000),
    epsilon=0.1)`` into ``F.cross_entropy(soft_label=True,
    reduction="none")`` masked at the pad id, and ``Adam(0.9, 0.98,
    1e-9)`` on ``lr.NoamDecay(512, 4000)``. Two warm-up steps, then
    slope+readback timing with the counters zeroed just before and read
    just after: 12 launches each of rows 3, 4 and 5 (six encoder
    self-attentions and six cross-attentions; the decoder's causal
    self-attention is dense) and 1 of row 6 a step, 30 of row 2 a
    forward; two more under ``torch.profiler``; the f32 eval loss over
    both batches falls; a ``save`` -> ``load`` into a fresh model and
    optimizer resumes bit for bit; row 6 is held to its plain version
    over the path's whole parameter list, gradients and moments, at the
    schedule's peak rate. Prints step ms, target tokens/s, MFU
    (``s2s_flops`` over 989 TFLOP/s), busy ms, idle share, kernels a
    step and peak memory. Then the f32 check (TF32 off) at full width,
    depth 2 + 2, dropout 0, on 8 x (128, 128) and 4 x (256, 128): the
    first gradients leaf by leaf, both paths' ReLU gradients on
    float64's side of each kink, within 1e-3 of float64's (each leaf's
    largest element and its norm), and three steps on the kernel path
    within 1e-4 of the plain path (the key biases within the steps'
    summed rates, as phase 7).
31. **Beam search.** Phase 30's weights in f32 decode 32 sources of the
    128 bucket through ``nn.BeamSearchDecoder(cell, 1, 2, beam_size=4)``
    and ``nn.dynamic_decode(max_step_num=source length + 50)``, the
    script's cell (``S2SCell``) over the decoder with incremental
    ``Cache`` self-attention and ``StaticCache`` cross-attention; once
    with the end token, and once with an end token past the vocabulary,
    so that every sentence runs to the length limit. Each: the counters
    show row 3 on the encoder (6 a call) and row 2 on 12 encoder and 18
    decoder LayerNorms a step; the kernel path's ids equal the plain
    path's, or the first step where they part is a near tie: the two
    candidates that swap there lie within LOGIT_TOL (1e-3) of each other
    on both paths, and the paths' beam scores lay within it before
    (``beam_divergence``, on the candidates the decoder's own sort
    ranked); prints ms a decode step, sentences/s and idle share.
32. **An attention LSTM seq2seq (the twelfth main path).** First row 7
    alone at the shapes the path's attention scores take (``ls_sm_shapes``:
    each seeded batch's f32 ``[rows, 1, S]``, S its longest source, here
    ``[128, 1, 50]`` in training and ``[320, 1, 48]`` in beam search, and
    ``[320, 1, 50]`` at the length limit) with ragged pads at -1e9:
    against its plain version, repeats
    bit for bit, its autograd gradient; timed beside its plain version,
    ``torch.softmax`` and its bound. Then the user script below
    (``ls_model``: Luong et al. 2015's global attention with the "general"
    score and input feeding at the IWSLT'15 En-Vi widths of PaddleNLP's
    ``examples/machine_translation/seq2seq``: ``nn.Embedding(17191, 512)``
    into ``nn.LSTM(512, 512, num_layers=2, dropout=0.2)``;
    ``nn.Embedding(7709, 512)`` into ``nn.RNN`` over a cell of two
    ``nn.LSTMCell``s, ``(1024 -> 512)`` and ``(512 -> 512)``, fed the
    target embedding and the previous attentional state, dropout 0.2 on
    each cell's output; ``scores = paddle.matmul(paddle.unsqueeze(h, [1]),
    W_a(enc_out), transpose_y=True)`` with the source pads at -1e9,
    ``F.softmax`` (row 7), the context ``p @ enc_out``, ``tanh(W_c [ctx;
    h])``; ``Linear(512, 7709)`` without bias; 26,935,808 seeded
    parameters) trains eagerly in f32 (TF32 off in matmuls and cuDNN) with
    ``Adam(1e-3)`` and ``nn.ClipGradByGlobalNorm(5.0)`` on two seeded
    batches of 128 cycled (ragged lengths 5-50, each target a fixed token
    map of its source), the loss the example's ``CrossEntropyCriterion``
    (``F.cross_entropy(reduction="none")`` masked by ``F.sequence_mask``,
    summed over the steps of the batch mean). Two warm-up steps, then
    slope+readback timing with the counters zeroed just before and read
    just after: one row-7 launch per decoder step (the batch's padded
    target length a step), one row-6 launch a step, no flash or LayerNorm;
    two more under ``torch.profiler``; the eval loss over both batches
    falls; a ``save`` -> ``load`` into a fresh model and optimizer resumes
    bit for bit; row 6 held to its plain version over the path's whole
    parameter list and timed beside ``torch.optim.Adam(fused=True,
    capturable=True)``. Prints step ms, target tokens/s, busy ms, idle
    share, kernels a step and peak memory. Then ``nn.LSTM`` (cuDNN) against
    two ``nn.RNN(nn.LSTMCell)`` layers over the same weights at ``[128,
    50, 512]``: outputs, final states and every gradient within 1e-5; and
    the f32 check at full width and depth, batch 16, dropout 0: three
    steps on the kernel path (rows 6-7) within 1e-4 of the plain path.
33. **LSTM beam search.** Phase 32's weights in f32 decode 32 sources
    through ``nn.BeamSearchDecoder(cell, 0, 1, beam_size=10,
    embedding_fn=..., output_fn=...)`` and ``nn.dynamic_decode(
    max_step_num=100, memory=...)``, the encoder's outputs and mask tiled
    by ``tile_beam_merge_with_batch``; once with the end token and once
    with an end token past the vocabulary (every sentence to the limit).
    Each: one row-7 launch a decode step at ``[320, 1, S]`` and no other
    kernel; the kernel path's ids equal the plain path's, or part at a
    near tie (``beam_divergence``); prints ms a decode step, sentences/s
    and idle share.
34. **ResNet-50 ImageNet training fed by the DataLoader (the thirteenth
    main path).** BASELINE config 2's input pipeline: a seeded
    ``DatasetFolder`` tree written to a temporary directory (64 class
    folders, 320 uint8 HWC ``.npy`` images of 256-512 px a side, read with
    ``loader=np.load``) under PaddleClas's ResNet50 training recipe
    (``RandomResizedCrop(224)``, ``RandomHorizontalFlip()``,
    ``Transpose()``, ``Normalize`` with the ImageNet mean and std), through
    ``io.DataLoader(batch_size=32, shuffle=True, drop_last=True,
    num_workers=W, use_shared_memory=True)``, W = min(8, cores - 1) worker
    processes over the shared-memory arena, batches staged on the card
    through pinned memory on the loader's copy stream. Phase 9's step
    (``ParallelEngine(resnet50(), Momentum(1e-3, 0.9), amp_dtype=
    "bfloat16")``, nothing cut) takes two epochs of 10 steps, each timed
    end to end with the wait in ``next`` included, the first two as
    warm-up; the counters zeroed just before and read just after: 53
    row-8 and 53 row-11 launches a step; two more steps under
    ``torch.profiler``, and ten on one batch staged on the card timed the
    same way (the loader's share). Then, on the deterministic eval pipeline
    (``Resize(256)``, ``CenterCrop(224)``): the batches with W workers and
    with ``num_workers=0`` equal ``np.stack`` of ``ds[i]`` over the epoch
    seed's indices bit for bit; the state after 4 batches resumes a fresh
    loader to the same remaining batches; worker 1 killed once through the
    port's chaos point (``loader_worker_kill``) is replaced and the epoch
    arrives in order, equal; every worker reports the CPU as its place;
    an eval forward over the loader launches row 9 53 times. Prints W, the
    cores, the median step and loader-wait ms, samples/s and the idle share
    beside phase 9's step.
35. **Eager LeNet on MNIST through the DataLoader (the fourteenth main
    path).** BASELINE config 1 as Paddle 2.0's quick start: seeded files
    in MNIST's layout and size (``train-images-idx3-ubyte.gz`` 60000 x 28
    x 28, its labels, the 10000-image test pair; each label the argmax of
    10 seeded projections of its image) through
    ``vision.datasets.MNIST(..., transform=Normalize(mean=[127.5],
    std=[127.5], data_format="CHW"))`` and ``io.DataLoader(batch_size=64,
    shuffle=True)`` (the single-process iterator and its staging thread);
    phase 15's eager loop for one whole epoch (938 steps, the last of 32),
    one row-6 launch a step, the mean loss of the last 100 steps below the
    first 100's; a second pass whose every batch equals the IDX arrays at
    the sampler's indices; the test set through ``F.softmax(model(x))``,
    one row-7 launch a batch, and its accuracy. The same loop timed the
    same way for 100 steps on two batches staged on the card, and fed by
    one worker process, says where the fed step's time goes. Prints the
    median step and loader-wait ms, images/s and the idle share beside
    phase 15's step.
36. **Generation in float16.** Phase 3's ten staggered requests served by
    the README's ``CausalLM`` (phase 3's seeded weights) in two arms:
    ``cache_dtype="float16"`` under the f32 model (row 1 with f32 queries
    over f16 pools) and ``lm.astype("float16")`` over an f16 pool (rows 1
    and 2 in f16), each with phase 3's gates and launch counts; the
    longest greedy stream re-run alone and its logits held to the plain
    forward of the same model (no kernel, no cache) within four f16
    rounding steps of the largest logit (``F16_LOGIT_REL``). Prints step
    ms, tokens/s, and a full-batch decode step's busy ms and idle share.
37. **The decode economics.** At the same width, each against phase 3's
    streams of the same requests, bit for bit, greedy and sampled:
    ``spec_tokens=4`` through the server with the n-gram speculator (its
    acceptance printed), and the engine driven by a
    ``DraftModelSpeculator`` proposing the stream's own continuation
    (every draft taken: row 1 launched 12 times per W = 5 window, one
    window per five tokens); ``int8=True`` served, its logits within 1e-3
    of a plain forward on the dequantized weights, the weight bytes ratio
    printed; ``resume_tokens`` at token 10 continuing the stream;
    ``preempt=True`` on a 40-page pool with priorities and
    ``gen_page_pressure`` chaos (parked and re-admitted streams equal,
    ``kv_pages_owed == 0``, ``unaccounted == 0``); ``gen_slot_wedge``
    failing only its stream.
38. **The batch Server over ResNet-50.** ``Server`` over
    ``resnet50()`` in eval, f32, channels-last, phase 9's seeded weights,
    buckets (1, 2, 4, 8, 16, 32), ``max_batch=32``,
    ``batch_timeout_ms=5``: 256 single-image requests from 4 client
    threads. Each output bit-equal to its row of the same padded bucket's
    direct forward and within 1e-4 of its own bucket-1 forward; 53 row-9
    launches per dispatched batch; ``unaccounted == 0``. Prints QPS
    batched and sequential, p50/p99 latency and the mean batch occupancy
    (Paddle Serving's ResNet50 example's online classification).

39. **Rows 8-12 in float16 (F24).** The training forward, the
    given-statistics forward, the local moments and both backward
    kernels on f16 rows over f16 and over f32 affine parameters, at
    ResNet-50's four shapes and YOLOv3's stem at 8 x 608² (``[2957312,
    32]``), identity and relu + residual: each against its plain version
    (f32 inside, one cast at the edge) within one f16 rounding step
    (``F16_REL``) plus ``BN_ABS``, the statistics, gamma/beta sums and
    moments at the f32 tolerance, repeats bit for bit; a float64 input
    raises. Timed (graph replay) in f16 beside the plain version, the
    bytes bound at itemsize 2 and ``F.batch_norm``'s f16 forward and
    backward (``torch.batch_norm_stats`` for the moments).
40. **ResNet-50 in float16.** Phase 9's configuration under
    ``ParallelEngine(amp_dtype="float16")``: three steps on one batch,
    finite and falling, 53 launches each of rows 8 and 11 a step, the
    step timed; an f16 eval forward of an f16 copy (53 row-9 launches);
    two steps on ``build_mesh(dp=1)`` over NCCL (53 launches each of
    rows 10 and 12 a step, in f16); and the f16 kernel path against the
    plain path at phase 9's depth cut (one bottleneck a stage, 32 x 64²),
    three steps from identical weights (``RN_F16_*`` tolerances).
41. **YOLOv3 training** at PaddleDetection's
    ``yolov3_darknet53_270e_coco.yml`` settings: ``yolov3(80)`` and
    ``yolov3_loss`` (``ignore_thresh`` 0.7, strides 32/16/8) through
    ``ParallelEngine(amp_dtype="bfloat16")`` with ``Momentum(1e-3, 0.9,
    L2Decay(5e-4))`` at batch 8 x 608² (one size of the 320-608
    multi-scale set), seeded synthetic images with 1-50 boxes each:
    ``YT_STEPS`` steps, the loss falling, 72 launches each of rows 8 and
    11 a step; step ms, images/s, device busy and idle, the batch norms'
    share of busy time, peak memory. Then the f32 kernel path against
    the plain path on a backbone cut to ``DarkNet53(depths=(1, 1, 1, 1,
    1))`` at ``YOLO_REF_BATCH`` x 608²: three steps, each from the plain
    path's state, both paths' leaky ReLUs taking their gradients on the
    pieces of a float64 forward of that state (``ActPieces``: one kink
    flip moves a first-step gradient by 1 %), the loss, parameters,
    running statistics and velocities within ``YT_REF_TOL``.
42. **VGG16-BN eval** (8 x 224², f32, batch norms calibrated, gamma and
    beta off 1 and 0): 13 row-9
    launches and none on the plain path, the logits within 1e-4 of the
    plain path's (of their max abs value), the warm forward timed by the
    slope protocol. Phases 23 and 28 run the new op and nn cases (the
    sequence ops, ``vision.ops``, the N-d and transposed convolutions
    and their layers, ``interpolate``'s resize modes) on the card.
43. **Collectives on NCCL** over the visible cards, one rank a card (on
    one card: world size 1, point-to-point skipped): every collective of
    ``distributed.collective`` and the Megatron pairs on card tensors,
    each against host arithmetic, then ``benches.py``'s all-reduce
    bus-bandwidth sweep (nccl-tests conventions, ``BUSBW_MB``), marked
    single-card where there is one.
44. **ERNIE-1.5B through fleet** (BASELINE config 4 by the user's entry
    points): ``fleet.init(is_collective=True, strategy)`` with ZeRO stage
    2 and ``amp``, ``apply_megatron_sharding``, ``fleet.parallel_engine``
    at full width and depth over NCCL, 4 x 512 a rank: timed by
    ``timed_steps``, phase 19's launch counts (24/24/24/1 of rows 3-6 a
    step, 50 of row 2 a forward), the loss finite and falling, peak
    memory, the optimizer slots held (1/n of the whole at sharding n),
    the collectives a step.
45. **The sharded and model-parallel engine across ranks:** two ranks
    (gloo on one card; NCCL one a card where there are two), ERNIE-1.5B at
    full width cut to depth 2, f32, global batch 4 x 512, at
    ``(sharding=2, zero 2)``, ``(sharding=2, zero 3)`` and ``(mp=2)``:
    three ``AdamW(1e-5)`` steps each within ``REF_TOL`` of the
    world-size-1 engine on the
    whole batch (losses and every parameter, the shards gathered), every
    rank launching rows 2-6 at its local shapes, each rank's slots half of
    the whole at sharding 2. Gloo takes CUDA tensors in every collective
    the engine calls (``tools/torch_hybrid_phases.py --gloo-probe``).

Phase 2 also holds rows 1 and 2 in float16: row 1 with f16 and f32
queries over f16 pools at W = 1 and W = 5, row 2 at ``[16, 512]`` and
BERT's ``[16384, 768]``, each within one f16 rounding step (``F16_REL``)
plus the f32 tolerance, timed beside the plain version, the bound and
(row 2) ``F.layer_norm`` in f16.

Before the last line it prints one JSON object ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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
# vocabulary [2048, 32000], a ragged width, BERT-base's masked-LM logits
# over its 30,522-word vocabulary at a fine-tuning batch of 32 x 128, and
# rows one element past the kernel's on-chip limit (ops/softmax.py
# WIDE_MAX, its two-pass path). f32: the same max, exps and a sum in
# another order agree to SM_TOL; bf16 and f16: one rounding step of the
# output (BF16_REL, F16_REL)
SM_SHAPES = ((64, 10), (32, 1000), (196608, 128), (2048, 32000),
             (1000, 1003), (4096, 30522), (2048, 32769))
SM_TIMED_DTYPES = (torch.bfloat16, torch.float32)
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


def ln_bound_ms(rows, h, itemsize=4):
    t_bytes = (2 * rows * h * itemsize + 2 * h * itemsize) / HBM_BYTES_PER_S
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
    out.update(f16_rows_phase(dev))
    return out


def f16_rows_phase(dev):
    """Phase 2's float16 cases: row 1 with f16 queries over f16 pools (an
    f16 model) and f32 queries over f16 pools (an f16 cache under an f32
    model), each at W = 1 (a decode step) and W = 5 (a window of 4
    drafts); row 2 at the decode step's [16, 512] and BERT's
    [16384, 768]. Each within one f16 rounding step plus the f32
    tolerance of its plain version, repeated bit for bit, and timed
    beside the plain version, its bound and (row 2) F.layer_norm in
    f16."""
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    rng = np.random.default_rng(SEED + 360)
    f16 = torch.float16
    paged = []
    for w in (1, 5):
        for q_dtype in (f16, torch.float32):
            q, pools, table, base = paged_case(rng, dev, w, n_pools=LAYERS)
            q = q.to(q_dtype)
            pools = [(kp.to(f16), vp.to(f16)) for kp, vp in pools]
            tag = f"f16 W={w} q={str(q_dtype).split('.')[-1]} kv=float16"
            check(pa.supported(q.shape, pools[0][0].shape, q_dtype, f16),
                  f"paged_attention {tag}: outside supported()")
            kp, vp = pools[0]
            got = pa.paged_attention(q, kp, vp, table, base)
            want = pa.paged_attention_ref(q, kp, vp, table, base)
            torch.cuda.synchronize()
            check(got.dtype == q_dtype and bool(torch.isfinite(got).all()),
                  f"paged_attention {tag}: dtype {got.dtype} or non-finite")
            check(torch.equal(pa.paged_attention(q, kp, vp, table, base),
                              got), f"paged_attention {tag}: a repeat "
                  "differs")
            # one rounding step of an f16 output (bf16_excess takes
            # F16_REL for f16), none for an f32 one
            excess = (bf16_excess(got, want) if q_dtype == f16
                      else float((got - want).abs().max()))
            check(excess <= PA_TOL, f"paged_attention {tag}: {excess} past "
                  "one f16 rounding step + PA_TOL")
            err = float((got.float() - want.float()).abs().max())
            ms = graph_time_ms([lambda kp=kp, vp=vp: pa.paged_attention(
                q, kp, vp, table, base) for kp, vp in pools])
            plain = graph_time_ms([lambda kp=kp, vp=vp: pa.paged_attention_ref(
                q, kp, vp, table, base) for kp, vp in pools])
            bound, by = paged_bound_ms(q, kp, base, w)
            paged.append(dict(
                shape=f"q{list(q.shape)} pool{list(kp.shape)} "
                      f"table{list(table.shape)}", window=w,
                q_dtype=str(q_dtype), kv_dtype=str(f16), max_abs_err=err,
                excess_over_rounding=excess, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None))
            log(f"paged_attention {tag}: max_abs_err={err:.3e} "
                f"kernel={ms:.5f}ms plain={plain:.5f}ms bound={bound:.5f}ms "
                f"({by})")
            del pools
    norms = []
    for rows, h in ((SLOTS, D_MODEL), (BATCH * SEQ, BERT_HIDDEN)):
        x = torch.from_numpy((rng.standard_normal((rows, h)) * 2 + 0.3)
                             .astype(np.float32)).to(dev, f16)
        w_, b_ = (torch.from_numpy(rng.standard_normal(h).astype(
            np.float32)).to(dev, f16) for _ in range(2))
        got = ln.fused_layer_norm(x, w_, b_)
        want = ln.layer_norm_ref(x, w_, b_)
        torch.cuda.synchronize()
        tag = f"layer_norm f16 rows={rows} H={h}"
        check(got.dtype == f16 and torch.equal(
            ln.fused_layer_norm(x, w_, b_), got), f"{tag}: dtype or repeat")
        excess = bf16_excess(got, want)
        check(excess <= LN_TOL, f"{tag}: {excess} past one f16 rounding step"
              " + LN_TOL")
        err = float((got.float() - want.float()).abs().max())
        ms = graph_time_ms([lambda: ln.fused_layer_norm(x, w_, b_)] * 24)
        plain = graph_time_ms([lambda: ln.layer_norm_ref(x, w_, b_)] * 24)
        lib = graph_time_ms([lambda: torch.nn.functional.layer_norm(
            x, (h,), w_, b_, 1e-5)] * 24)
        bound, by = ln_bound_ms(rows, h, itemsize=2)
        norms.append(dict(shape=f"x[{rows}, {h}] float16", max_abs_err=err,
                          excess_over_rounding=excess, ms=ms,
                          plain_ms=plain, bound_ms=bound, bound_by=by,
                          library_ms=lib))
        log(f"{tag}: max_abs_err={err:.3e} kernel={ms:.5f}ms "
            f"plain={plain:.5f}ms library={lib:.5f}ms bound={bound:.5f}ms "
            f"({by})")
    return {"paged_attention_f16": paged, "layer_norm_f16": norms}


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
    """How far |got - want| exceeds one rounding step of want in its
    16-bit type (bf16: 2^-7 relative, f16: 2^-10)."""
    step = F16_REL if want.dtype == torch.float16 else BF16_REL
    got, want = got.float(), want.float()
    return float(((got - want).abs() - step * want.abs()).max())


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
    # the tensor cores' dense peak is the same in bf16 and f16
    peak = BF16_FLOPS_PER_S if el == 2 else F32_FLOPS_PER_S
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
# ERNIE-1.5B at pp 2 (phase 46): one microbatch a stage step
ERNIE_MICRO_ATTN = (1,) + ERNIE_ATTN[1:]
# Ulysses (phase 47): ERNIE's attention with the heads cut over 2 ranks
ULYSSES_ATTN = ERNIE_ATTN[:2] + (ERNIE_HEADS // 2, ERNIE_ATTN[3])
# BERT-base fine-tuning (phase 21): f32, batch 32, seq 128, ragged padding
FT_ATTN = (FT_BATCH, FT_SEQ, BERT_HEADS, BERT_HIDDEN // BERT_HEADS)


def flash_case(dev, dtype, seed, n_sets=1, shape=BERT_ATTN):
    """``n_sets`` independent (q, k, v, dout) sets at ``shape`` (the
    BERT-base attention shape by default), a keep-mask with ragged tails
    and batch row 0 fully padded (where the batch has more than one row),
    and the all-keep mask the main path's batch gives."""
    b, n = shape[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    sets = [[torch.randn(*shape, device=dev, generator=g).to(dtype)
             for _ in range(4)] for _ in range(n_sets)]
    lens = np.random.default_rng(seed).integers(32, n + 1, b)
    if b > 1:
        lens[0] = 0
    keep = torch.from_numpy(np.arange(n)[None, :] < lens[:, None]).to(dev)
    return sets, keep, torch.ones(b, n, dtype=torch.bool, device=dev)


FLASH_CASES = ((torch.float32, False, BERT_ATTN),
               (torch.float32, True, BERT_ATTN),
               (torch.bfloat16, False, BERT_ATTN),
               (torch.bfloat16, True, BERT_ATTN),
               (torch.float32, False, ERNIE_ATTN),
               (torch.bfloat16, False, ERNIE_ATTN),
               (torch.float32, False, FT_ATTN),
               (torch.bfloat16, False, ERNIE_MICRO_ATTN),
               (torch.float32, False, ERNIE_MICRO_ATTN),
               (torch.bfloat16, False, ULYSSES_ATTN),
               (torch.float32, False, ULYSSES_ATTN))
# float16 (phase 25): the fine-tuning shape with its ragged keep-mask,
# causal too, and ERNIE-1.5B's
FLASH_F16_CASES = ((torch.float16, False, FT_ATTN),
                   (torch.float16, True, FT_ATTN),
                   (torch.float16, False, ERNIE_ATTN))


def flash_check(dev, cases=FLASH_CASES):
    """Hold the three flash kernels to their plain versions in f32 and
    bf16 (padded tails, one fully padded row; causal in both; both also
    at ERNIE-1.5B's [4, 512, 18, 128], at its pipeline microbatch's
    [1, 512, 18, 128] and at Ulysses' [4, 512, 9, 128]; ``cases`` are
    (dtype, causal, shape)). The 16-bit cases, which run the tensor-core kernels, must
    repeat bit for bit and stay within one rounding step of their type
    beyond FLASH_BF16_ABS."""
    from paddle1_tpu_torch.ops import flash_attention as fa
    from paddle1_tpu_torch.ops import flash_attention_bwd as fb
    errs = {"fwd": [], "dkv": [], "dq": []}
    for dtype, causal, shape in cases:
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
        if dtype != torch.float32:
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
        if shape[0] > 1:
            check(float(out[0].abs().max()) == 0.0 and
                  float(rl[0].max()) <= -1e29 and
                  float(lse[0].max()) <= -1e29,
                  f"flash fwd {tag}: the fully padded row is not O=0, "
                  "LSE=-1e30")
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
                      f"one rounding step of its type by {exc}")
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


def adam_check(fad, ts, sc, decs, scales, tag, betas=(0.9, 0.999, 1e-8)):
    """Run the kernel once over ``ts`` = (p, g, m1, m2) and hold every
    output to the plain version; ``betas``: beta1, beta2, epsilon. Returns
    the max abs error."""
    ps, gs, m1, m2 = ts
    b1, b2, eps = betas
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
    (past the warp-per-row widths: the block-per-row kernel) and its
    pipeline microbatch's ``[512, 2304]``, in bf16 and f32. f32 is held to LN_TOL, bf16 to one rounding step."""
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


def bn_check(dev, shapes=BN_SHAPES, acts=("identity", "relu"),
             residuals=(False, True)):
    """Every kernel of the family against its plain version at ``shapes``
    (``[rows, C]``; the four of BN_SHAPES), f32 and bf16, ``acts`` x
    ``residuals``, the training forward, the training backward and the
    given-statistics forward also repeated bit for bit; returns the max
    abs errors."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    errs = {k: [] for k in bn_counters()}
    eps = 1e-5
    for rows, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            (x, g, b, res, m, v, dy), = bn_inputs(dev, rows, c, dtype,
                                                  SEED + rows + c)
            for act in acts:
                for use_res in residuals:
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
            log(f"batch norm kernels [{rows}, {c}]: f32 and bf16 x {acts} "
                f"x residual {residuals} within tolerance, repeats "
                "bit-identical")
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


def bn_reread_rows(rows, c, dtype=torch.bfloat16):
    """``{kind: (rows, plan)}`` of the cooperative training kernels (the
    forward and the backward) at ``[rows, C]`` in ``dtype`` (affine
    parameters of the same dtype) on this card: the rows their plans leave
    out of shared memory (read again in the last phase) and the plans; a
    kernel whose module has no plan (an older tree) is left out."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    x = torch.empty(rows, c, dtype=dtype, device="cuda")
    out = {}
    for kind, plan in (("fused_bn_train",
                        getattr(fbn, "train_fwd_launch_plan", None)),
                       ("fused_bn_train_bwd",
                        getattr(fbb, "train_bwd_launch_plan", None))):
        if plan is None:
            continue
        p = plan(x, {torch.bfloat16: 1, torch.float16: 2}.get(dtype, 0))
        held = sum(min(p.resident, rows - k * p.rows_per_chunk)
                   for k in range(p.chunks))
        out[kind] = (rows - held, p._asdict())
    return out


BN_FLOPS = {"fused_bn_train": 7.0, "fused_bn_norm": 4.0,
            "fused_bn_train_bwd": 10.0, "fused_bn_norm_bwd": 7.0}


def bn_timing(dev, shapes=BN_SHAPES, images=RN_BATCH,
              dtype=torch.bfloat16):
    """Time the four kernels at ``shapes`` (default BN_SHAPES, ResNet-50's)
    in ``dtype`` (identity, no residual: every batch norm of the main
    path), over 4 input sets in turn, beside their plain versions,
    F.batch_norm on the same data as a channels-last [N, C, H, W] tensor
    of ``images`` square images, and their bounds; the bytes the design
    moves from the cooperative kernels' plans (their resident rows),
    where the imported tree has them."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    tbf = torch.nn.functional.batch_norm
    out = {k: [] for k in bn_counters()}
    eps = 1e-5
    itemsize = torch.empty((), dtype=dtype).element_size()
    dname = {torch.bfloat16: "bf16", torch.float32: "f32",
             torch.float16: "f16"}[dtype]
    for rows, c in shapes:
        plans = bn_reread_rows(rows, c, dtype)
        sets = bn_inputs(dev, rows, c, dtype, SEED + 9, n_sets=4)
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
        # the library: the same rows as [N, C, H, W] channels-last (N =
        # ``images``, H = W), f32 affine and running statistics
        hw = rows // images
        side = int(round(hw ** 0.5))
        check(side * side * images == rows, f"{rows} rows are not "
              f"{images} square images")
        lib = [(s[0].view(images, side, side, c).permute(0, 3, 1, 2),
                s[1].float(), s[2].float(), s[4].clone(), s[5].clone(),
                s[6].view(images, side, side, c).permute(0, 3, 1, 2))
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
            need, moved = bn_bytes(name, rows, c, itemsize, reread)
            b_ms, by = bound(need, BN_FLOPS[name] * rows * c,
                             F32_FLOPS_PER_S)
            lk, cover = lib_for[name]
            out[name].append({
                "shape": [rows, c], "dtype": dname, "act": "identity",
                "residual": False, "ms": t[name],
                "plain_ms": t[name + "_plain"], "library_ms": t[lk],
                "library_covers": cover, "bound_ms": b_ms, "bound_by": by,
                "bound_bytes": need, "design_bytes": moved,
                "design_bytes_ms_at_peak": 1e3 * moved / HBM_BYTES_PER_S})
            if plan is not None:
                out[name][-1]["plan"] = plan
            log(f"{name} {dname} [{rows}, {c}]: kernel {t[name]:.5f} ms, plain "
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


class ActPieces:
    """Forward hooks on a port model's ReLU, ReLU6 and LeakyReLU layers,
    which deep copies of the model share. ``mode`` ``"record"``: keep,
    call by call, which side of its kinks (0, and 6 for ReLU6) each input
    element lies on; ``"replay"``: take each call's gradient on the
    recorded sides (its forward value unchanged; a leaky ReLU's slope on
    the negative side), and count the elements whose own side differs
    (``flips``, by layer) and their largest distance to the kink
    (``far``); None: nothing. :meth:`restart` before each replayed run."""

    def __init__(self, model):
        from paddle1_tpu_torch.nn import LeakyReLU, ReLU, ReLU6
        self.mode, self.sides, self.flips, self.far = None, {}, {}, 0.0
        self.calls = {}
        self.handles = [
            m.register_forward_hook(
                lambda mod, inp, out, n=n, six=isinstance(m, ReLU6),
                slope=getattr(m, "negative_slope", 0.0) if isinstance(
                    m, LeakyReLU) else 0.0:
                    self._hook(n, six, inp[0], out, slope))
            for n, m in model.named_modules()
            if isinstance(m, (ReLU, ReLU6, LeakyReLU))]

    def _hook(self, name, six, x, out, slope=0.0):
        if self.mode is None:
            return None
        xd = x.detach()
        side = (xd > 0) & (xd < 6) if six else xd > 0
        i = self.calls.get(name, 0)
        self.calls[name] = i + 1
        if self.mode == "record":
            self.sides[name, i] = side
            return None
        want = self.sides[name, i]
        off = side != want
        n = int(off.sum())
        if n:
            d = xd[off].abs()
            if six:
                d = torch.minimum(d, (xd[off] - 6).abs())
            self.flips[name] = self.flips.get(name, 0) + n
            self.far = max(self.far, float(d.max()))
        if slope:
            return out.detach() + (x - xd) * torch.where(
                want, torch.ones((), dtype=x.dtype, device=x.device),
                torch.full((), slope, dtype=x.dtype, device=x.device))
        return out.detach() + (x - xd) * want.to(x.dtype)

    def restart(self):
        self.calls = {}

    def take(self):
        """``{"flips", "layers", "far"}`` since the last call (the count,
        by layer, the largest distance), then reset."""
        out = {"flips": sum(self.flips.values()), "layers": self.flips,
               "far": self.far}
        self.flips, self.far = {}, 0.0
        return out

    def remove(self):
        for h in self.handles:
            h.remove()


def rn_grad_gaps(model, batch, loss_fn=None, floor=0.0, pieces=False):
    """First-step gradients of ``model`` (f32) on the kernel path, on the
    plain path twice and in float64 (the plain path): per parameter
    ``|g_a - g_b| / |g_f64|``, the worst over the parameters of each
    pair, and that parameter's name. ``loss_fn`` defaults to
    :func:`rn_loss_fn`; ``floor``: each denominator at least that share of
    the largest parameter's ``|g_f64|`` (for parameters whose exact
    gradient is zero); ``pieces``: the kernel path and the plain path run
    again with the gradients of the model's ReLU/ReLU6 layers taken on
    float64's side of each kink (:class:`ActPieces`; ``kernel_same_piece``
    and ``plain_same_piece``), and ``flips`` counts the elements each
    path's own forward puts on the other side."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    loss_fn = loss_fn or rn_loss_fn
    names = [n for n, _ in model.named_parameters()]
    acts = ActPieces(model) if pieces else None
    plain = dict(fused_bn="never", fused_bn_bwd="never")
    flips = {}
    try:
        runs = {"kernel": rn_first_grads(copy.deepcopy(model), batch,
                                         loss_fn)}
        with flags_guard(**plain):
            for k in ("plain", "plain_again"):
                runs[k] = rn_first_grads(copy.deepcopy(model), batch,
                                         loss_fn)
            with flags_guard(conv_nhwc="never"):
                exact = {"x": batch["x"].double(), "y": batch["y"]}
                if acts:
                    acts.mode = "record"
                runs["f64"] = rn_first_grads(copy.deepcopy(model).double(),
                                             exact, rn_f64_loss_fn)
        if acts:
            acts.mode = "replay"
            for k, flags in (("kernel", {}), ("plain", plain)):
                with flags_guard(**flags):
                    acts.restart()
                    runs[f"{k}_same_piece"] = rn_first_grads(
                        copy.deepcopy(model), batch, loss_fn)
                flips[k] = acts.take()
    finally:
        if acts:
            acts.remove()
    ref = runs["f64"][1]
    top = max(float(g.norm()) for g in ref)
    gaps = {}
    pairs = [("kernel", "plain"), ("kernel", "f64"), ("plain", "f64"),
             ("plain", "plain_again")]
    if acts:
        pairs += [("kernel_same_piece", "plain_same_piece"),
                  ("kernel_same_piece", "f64"), ("plain_same_piece", "f64")]
    for a, b in pairs:
        rel = [float((ga - gb).norm() /
                     gr.norm().clamp_min(max(floor * top, 1e-30)))
               for ga, gb, gr in zip(runs[a][1], runs[b][1], ref)]
        i = int(np.argmax(rel))
        gaps[f"{a}_vs_{b}"] = {"max": rel[i], "param": names[i],
                               "median": float(np.median(rel))}
    out = {"losses": {k: v[0] for k, v in runs.items()}, "gaps": gaps}
    if acts:
        out["flips"] = flips
    return out


def rn_engine_steps(model, batch, steps, amp=None):
    """``steps`` Momentum steps of ``model`` through ParallelEngine (f32,
    or under ``amp_dtype=amp``); returns the losses."""
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import Momentum
    eng = ParallelEngine(model, Momentum(learning_rate=RN_LR, momentum=0.9,
                                         parameters=model.parameters()),
                         rn_loss_fn, amp_dtype=amp)
    return [float(eng.step(batch)) for _ in range(steps)]


def reference_readings(dev, model, data_seed, batch, img, steps_fn,
                       steps=0, loss_fn=None, floor=0.0, pieces=False,
                       **about):
    """``model`` (f32, on ``dev``) at batch ``batch`` x 3 x ``img``², data
    from ``data_seed``, cuDNN deterministic:

    * ``grads``: the first step's gradients on the kernel path, the plain
      path (``fused_bn``/``fused_bn_bwd`` never: the plain batch-norm arm),
      a repeat of the plain path and float64 (:func:`rn_grad_gaps` with
      ``loss_fn``, ``floor`` and ``pieces``);
    * with ``steps``, ``steps_fn(model, data, steps)`` (the losses) on the
      kernel path and on the plain path from identical weights: the
      losses, and the largest differences of the parameters and of the
      running statistics after the last step, beside the largest move of
      a parameter;
    * the kernel launches of the kernel path's steps and the plain path's.

    ``about`` goes into the readings as it is."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    counters = bn_counters()
    try:
        m_kernel = model
        m_plain = copy.deepcopy(m_kernel)
        init = {k: v.detach().clone()
                for k, v in m_kernel.state_dict().items()}
        rng = np.random.default_rng(data_seed)
        data = {"x": torch.from_numpy(rng.standard_normal(
                    (batch, 3, img, img)).astype(np.float32)).to(dev),
                "y": torch.from_numpy(rng.integers(
                    0, 1000, (batch,))).to(dev)}
        out = {"dtype": "float32", **about,
               "batch_norms": sum(k.endswith("._mean") for k in init),
               "batch": batch, "img": img, "steps": steps,
               "grads": rn_grad_gaps(m_kernel, data, loss_fn, floor,
                                     pieces)}
        before = bn_launches(counters)
        out["losses_kernel"] = steps_fn(m_kernel, data, steps)
        mid = bn_launches(counters)
        with flags_guard(fused_bn="never", fused_bn_bwd="never"):
            out["losses_plain"] = steps_fn(m_plain, data, steps)
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


def reference_check(name, full, cuts):
    """The checks of :func:`resnet_reference_check` on readings of
    :func:`reference_readings`: ``full`` at full depth, ``cuts`` on the
    depth cut (the first with the steps). Readings with the gradients on
    float64's ReLU/ReLU6 pieces (``pieces``) hold those to RN_GRAD_TOL,
    at full depth too; others hold the cut's own gradients to it."""
    cut = cuts[0]
    want = {"fused_bn_train": cut["batch_norms"] * REF_STEPS,
            "fused_bn_norm": 0,
            "fused_bn_train_bwd": cut["batch_norms"] * REF_STEPS,
            "fused_bn_norm_bwd": 0}
    check(cut["launches_kernel"] == want, f"{name}: the kernel path "
          f"launched {cut['launches_kernel']}, want {want}")
    for r in [full] + cuts:
        check(not any(r["launches_plain"].values()),
              f"{name}: the plain path launched {r['launches_plain']}")
        check(r["grads"]["gaps"]["plain_vs_plain_again"]["max"] == 0.0,
              f"{name}: the plain path does not repeat bit for bit")
    losses = full["grads"]["losses"]
    check(abs(losses["kernel"] - losses["plain"]) <= REF_TOL,
          f"{name} full depth: first losses differ: {losses}")
    gaps = full["grads"]["gaps"]
    for stat in ("max", "median"):
        k, p = gaps["kernel_vs_f64"][stat], gaps["plain_vs_f64"][stat]
        check(k <= RN_F64_FACTOR * p, f"{name} full depth: the kernel "
              f"path's gradients are {k} ({stat}) from float64, the plain "
              f"path's {p}")
    same = "kernel_same_piece_vs_plain_same_piece"
    held = cuts + ([full] if same in gaps else [])
    for r in held:
        key = same if same in r["grads"]["gaps"] else "kernel_vs_plain"
        gap = r["grads"]["gaps"][key]
        check(gap["max"] <= RN_GRAD_TOL, f"{name} (img {r['img']}, seed "
              f"{r['seed']}): first-step gradients differ by {gap['max']} "
              f"of the float64 gradient at {gap['param']} (> "
              f"{RN_GRAD_TOL}, {key})")
    for key in ("max_loss_err", "max_param_err", "max_running_stat_err"):
        check(cut[key] <= REF_TOL, f"{name} depth cut: {key} {cut[key]} > "
              f"{REF_TOL}")


def resnet_reference_readings(dev, batch, img, blocks=None, steps=0):
    """:func:`reference_readings` of ResNet-50 at full width (``blocks``:
    the depth cut to the first blocks of each stage), seeded weights and
    data, steps through ParallelEngine (:func:`rn_engine_steps`)."""
    from paddle1_tpu_torch.vision.models import resnet50
    model = resnet50(device=dev,
                     generator=torch.Generator().manual_seed(SEED + 8))
    if blocks is not None:
        for i in range(1, 5):
            name = f"layer{i}"
            setattr(model, name, getattr(model, name)[:blocks])
    return reference_readings(dev, model, SEED + 8, batch, img,
                              rn_engine_steps, steps, seed=SEED + 8,
                              blocks_per_stage=blocks)


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
    reference_check("resnet", full, [cut])
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
        times += moments_timing(dev, ((rows, c),), RN_BATCH, torch.bfloat16)
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
    bn, kernels, bn_us = {}, {}, 0.0
    for e in events:
        for name in BN_KERNELS["fused_bn"] + BN_KERNELS["fused_bn_bwd"] + (
                "finalize_kernel",):
            if name in e.name:
                bn[name] = bn.get(name, 0) + 1
                bn_us += e.time_range.elapsed_us()
        us, k = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"kernels_per_step": len(events) / n,
            "device_busy_ms_per_step": sum(
                e.time_range.elapsed_us() for e in events) / 1e3 / n,
            "profiled_step_ms": wall_ms,
            "bn_kernels_per_step": {k: v / n for k, v in bn.items()},
            "bn_ms_per_step": bn_us / 1e3 / n,
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
    against plain autograd in f32; then timed in bf16 and f32
    (SM_TIMED_DTYPES) over enough input sets to leave the L2 cache, beside
    its plain version, ``torch.softmax`` (the library) and its bound: x
    read once and y written once, ``2·rows·h·itemsize`` bytes, five f32
    operations per element."""
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
    for dtype in SM_TIMED_DTYPES:
        name = str(dtype).split(".")[-1]
        for rows, h in SM_SHAPES:
            item = torch.tensor([], dtype=dtype).element_size()
            need = 2 * rows * h * item
            n_sets = max(1, min(4, -(-200_000_000 // need)))
            g = torch.Generator(device=dev).manual_seed(SEED + 16)
            xs = [torch.randn(rows, h, device=dev, generator=g).to(dtype)
                  for _ in range(n_sets)]
            t = {"ms": graph_time_ms([lambda x=x: psm.softmax_fwd(x)
                                      for x in xs]),
                 "plain_ms": graph_time_ms([lambda x=x: psm.softmax_ref(x)
                                            for x in xs]),
                 "library_ms": graph_time_ms([
                     lambda x=x: torch.softmax(x, dim=-1) for x in xs])}
            b_ms, by = bound(need, 5.0 * rows * h, F32_FLOPS_PER_S)
            times.append({"shape": [rows, h], "dtype": name, **t,
                          "path": psm.plan(rows, h, item).path,
                          "library_covers": "torch.softmax (last axis)",
                          "bound_ms": b_ms, "bound_by": by,
                          "bound_bytes": need, "input_sets": n_sets})
            log(f"softmax {name} [{rows}, {h}]: kernel {t['ms']:.5f} ms, "
                f"plain {t['plain_ms']:.5f} ms, torch.softmax "
                f"{t['library_ms']:.5f} ms, bound {b_ms:.5f} ms ({by})")
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
    from paddle1_tpu_torch.ops import (linalg_ops, manip_ops, math_ops,
                                       sequence_ops)
    from paddle1_tpu_torch.vision import ops as vision_ops
    cases = op_cases()
    card = f"gpu:{dev.index or 0}"
    groups = (("math_ops", math_ops, cases.math_cases()),
              ("manip_ops", manip_ops, cases.manip_cases()),
              ("linalg_ops", linalg_ops, cases.linalg_cases()),
              ("Tensor", None, cases.method_cases()),
              ("sequence_ops", sequence_ops, cases.sequence_cases()),
              ("vision_ops", vision_ops, cases.vision_cases()))
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
              for m in (math_ops, manip_ops, linalg_ops, sequence_ops)
              for n in m.__all__}
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


# ---------------------------------------------------------------------------
# phases 25-27: float16 on rows 3-6, and eager fine-tuning under AMP

# phase 26-27: timed steps a trial (slope+readback, 3 trials), the steps an
# AMP run takes before its timing, at most AMP_SKIP_MAX skipped f16 steps
# before one applies, the step-1 loss's relative distance from the f32
# path's, and float16 O1's first loss scale (2^40 overflows the f16
# gradients: the scaler must skip and halve until they are finite)
AMP_STEPS, AMP_CHECK_STEPS, AMP_SKIP_MAX = 12, 3, 60
AMP_LOSS_RTOL, AMP_F16_INIT_SCALE = 2e-2, 2.0 ** 40


def f16_kernels_phase(dev):
    """Phase 25 (the module docstring): rows 3-6 in float16."""
    from paddle1_tpu_torch.ops import fused_adam as fad
    errs = flash_check(dev, FLASH_F16_CASES)
    timing = {}
    for name, shape, ragged in (("bert_finetune", FT_ATTN, True),
                                ("ernie", ERNIE_ATTN, False)):
        t, b, sh = flash_timing(dev, shape, torch.float16, ragged=ragged)
        timing[name] = {"shape": sh, "ms": {k: t[k] for k in (
            "fwd", "dkv", "dq", "fwd_plain", "bwd_plain", "fwd_library",
            "bwd_library", "fwd_bwd_library", "fwd_bwd_library_eager")},
            "library_ops": t["library_backend"],
            "bound_ms": {k: v[0] for k, v in b.items()},
            "bound_by": {k: v[1] for k, v in b.items()}}

    # row 6 over BERT-base's 110 M parameters in float16 (f32 moments):
    # aligned, mixed scales, views at odd offsets; then timed beside the
    # library's fused AdamW on the same float16 parameters
    g = torch.Generator(device=dev).manual_seed(SEED + 250)
    shapes = bert_shapes()
    n_el = sum(int(np.prod(s)) for s in shapes)
    sc = torch.tensor([LR, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    mixed = [ADAM_SCALES[i % len(ADAM_SCALES)] for i in range(len(shapes))]
    mixed_dec = [(0.01, 0.0)[i % 2] for i in range(len(shapes))]
    decays = [0.01] * len(shapes)
    adam_errs = []
    for scales, decs, unaligned in ((None, decays, False),
                                    (mixed, mixed_dec, False),
                                    (mixed, mixed_dec, True)):
        ts = adam_tensors(shapes, torch.float16, g, dev, unaligned)
        tag = (f"float16 over {len(shapes)} tensors ({n_el} elements), lr "
               f"scales {sorted(set(scales or [1.0]))}"
               f"{', views at odd offsets' if unaligned else ''}")
        adam_errs.append({"dtype": "torch.float16", "max_abs_err":
                          adam_check(fad, ts, sc, decs, scales, tag),
                          "lr_scales": sorted(set(scales or [1.0])),
                          "unaligned_views": unaligned})
        del ts
    ps, gs, m1, m2 = adam_tensors(shapes, torch.float16, g, dev)
    lib_ps = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    for p, q in zip(lib_ps, gs):
        p.grad = q
    lib_opt = torch.optim.AdamW(lib_ps, lr=LR, weight_decay=0.01,
                                fused=True, capturable=True)
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = alternating_ms({"kernel": lambda: fad.fused_adam_(
        ps, gs, m1, m2, sc, decays, b1, b2, eps), "library": lib_opt.step})

    def plain():
        for p, q, a, b in zip(ps, gs, m1, m2):
            np_, na, nb = fad.fused_adam_ref(p, q, a, b, sc[0], sc[1], sc[2],
                                             0.01, b1, b2, eps)
            p.copy_(np_)
            a.copy_(na)
            b.copy_(nb)
    plain_ms = graph_time_ms([plain], reps=5)
    b_ms, by = bound((3 * 2 + 16.0) * n_el, 12.0 * n_el, F32_FLOPS_PER_S)
    adam = {"ms": t["kernel"]["median_ms"],
            "ms_spread": t["kernel"]["spread_ms"],
            "library_ms": t["library"]["median_ms"],
            "library_ms_spread": t["library"]["spread_ms"],
            "library_bytes_per_element": 14, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "elements": n_el,
            "rounds_ms": {k: v["rounds_ms"] for k, v in t.items()},
            "cases": adam_errs}
    log(f"fused_adam timing (float16, {n_el} elements, 1 launch; "
        f"alternating rounds of graph replays): {adam['ms']:.5f} ms (spread "
        f"{adam['ms_spread']:.5f}; library {adam['library_ms']:.5f}; plain "
        f"{plain_ms:.5f}; bound {b_ms:.5f} {by})")
    del ps, gs, m1, m2, lib_ps, lib_opt
    torch.cuda.empty_cache()
    out = {"flash_errors": errs, "flash_timing": timing, "fused_adam": adam}
    log(json.dumps({"f16_kernels": out}))
    return out


class FlashDtypes:
    """Record the dtype of every flash forward's q while open (through the
    wrapper's input check, so no launch is counted twice)."""

    def __enter__(self):
        from paddle1_tpu_torch.ops import flash_attention as fa
        self.fa, self.orig, self.seen = fa, fa._check, set()

        def spy(name, q, *a):
            self.seen.add(str(q.dtype).split(".")[-1])
            return self.orig(name, q, *a)
        fa._check = spy
        return self

    def __exit__(self, *exc):
        self.fa._check = self.orig


def amp_step_fn(paddle, clf, opt, batches, level, dtype, scaler=None,
                grads_f32=False):
    """One eager step under ``auto_cast(level=level, dtype=dtype)``:
    ``scaler.scale(loss).backward(); scaler.step(opt)`` (plain
    ``backward``/``step`` without a scaler), ``opt.clear_grad()``.
    ``grads_f32``: check that every gradient is float32."""
    F = paddle.nn.functional
    turn = [0]

    def step():
        x, y = batches[turn[0] % len(batches)]
        turn[0] += 1
        with paddle.amp.auto_cast(level=level, dtype=dtype):
            loss = F.cross_entropy(clf(x), y)
        (loss if scaler is None else scaler.scale(loss)).backward()
        if grads_f32:
            check(all(p.grad.dtype == torch.float32
                      for p in clf.parameters()),
                  "auto_cast: a float32 parameter's gradient is not float32")
        if scaler is None:
            opt.step()
        else:
            scaler.step(opt)
        opt.clear_grad()
        return loss
    return step


def amp_launches(step, n, flash_dtype, scaler=None, tag=""):
    """``n`` steps of the main path with the counters zeroed just before
    and read just after; the flash forwards must run in ``flash_dtype``,
    the losses be finite, and each launch count be a step's (12 flash
    forward, dK/dV and dQ launches, 25 LayerNorm launches a forward, one
    fused AdamW an applied step; a step ``scaler`` skips launches no
    AdamW). Returns (launches, losses, applied steps)."""
    counters = train_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, applied = [], 0
    with FlashDtypes() as fd:
        for _ in range(n):
            losses.append(float(step()))
            applied += scaler is None or not scaler.last_step_skipped()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(fd.seen == {flash_dtype}, f"{tag}: flash ran on {fd.seen}, want "
          f"{flash_dtype}")
    check(all(np.isfinite(losses)), f"{tag}: non-finite losses {losses}")
    want = {"flash_attention": BERT_LAYERS * n,
            "flash_attention_bwd_dkv": BERT_LAYERS * n,
            "flash_attention_bwd_dq": BERT_LAYERS * n, "fused_adam": applied,
            "layer_norm": (2 * BERT_LAYERS + 1) * n}
    check(launches == want and applied > 0, f"{tag}: launches {launches} "
          f"over {n} steps ({applied} applied), want {want}")
    return launches, losses, applied


def amp_timing(step, n_params, tag):
    """Slope+readback step time (phase 21's protocol), samples/s, MFU
    (phase 21's FLOPs over the 16-bit dense peak), and two profiled steps'
    device busy time and the idle share against the untraced step."""
    slopes, _, _ = timed_steps(step, AMP_STEPS)
    dt = float(np.median(slopes))
    prof = device_kernels_per_step(step, 2)
    busy = prof["device_busy_ms_per_step"]
    flops = (6 * n_params * FT_BATCH * FT_SEQ +
             12 * BERT_LAYERS * FT_BATCH * FT_SEQ ** 2 * BERT_HIDDEN)
    out = {"step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
           "step_ms_max": max(slopes) * 1e3, "samples_per_s": FT_BATCH / dt,
           "tokens_per_s": FT_BATCH * FT_SEQ / dt, "flops_per_step": flops,
           "mfu": flops / dt / BF16_FLOPS_PER_S,
           "mfu_peak": "bf16/f16 dense 989 TFLOP/s",
           "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / (dt * 1e3),
           "kernels_per_step": prof["kernels_per_step"],
           "top_kernels": prof["top_kernels"][:6]}
    log(f"{tag}: {out['step_ms_median']:.2f} ms a step "
        f"({out['samples_per_s']:.1f} samples/s, MFU {out['mfu']:.3f}; "
        f"busy {busy:.2f} ms, idle {out['device_idle_share']:.3f})")
    return out


def params_and_moments(clf, opt):
    """Copies of every parameter and Adam moment, in order."""
    out = [p.detach().clone() for p in clf.parameters()]
    for p in clf.parameters():
        out += [t.clone() for t in opt._slots.get(id(p), {}).values()]
    return out


def finetune_amp_phase(dev, ft):
    """Phase 26 (the module docstring). ``ft``: phase 21's summary."""
    import paddle1_tpu_torch as paddle
    clf, opt, _, batches, _ = ft_setup(paddle)
    n_params = sum(p.nelement() for p in clf.parameters())
    check({p.dtype for p in clf.parameters()} == {torch.float32},
          "O1 fine-tuning: the parameters are not float32")
    # (a) bf16: the step-1 loss against the f32 path's, on the same
    # weights, batch and dropout masks
    x, y = batches[0]
    F = paddle.nn.functional
    with paddle.no_grad():
        torch.manual_seed(SEED + 260)
        f32_loss = float(F.cross_entropy(clf(x), y))
        torch.manual_seed(SEED + 260)
        with paddle.amp.auto_cast():
            amp_loss = float(F.cross_entropy(clf(x), y))
    rel = abs(amp_loss - f32_loss) / abs(f32_loss)
    check(rel <= AMP_LOSS_RTOL, f"bf16 O1 step-1 loss {amp_loss} is "
          f"{rel:.3e} from the f32 path's {f32_loss}")
    step = amp_step_fn(paddle, clf, opt, batches, "O1", "bfloat16",
                       grads_f32=True)
    step()
    bf16_launches, bf16_losses, _ = amp_launches(
        step, AMP_CHECK_STEPS, "bfloat16", tag="bf16 O1")
    bf16 = amp_timing(amp_step_fn(paddle, clf, opt, batches, "O1",
                                  "bfloat16"), n_params,
                      "fine-tuning, O1 bfloat16")

    # (b) float16 with GradScaler(2^40): overflowing steps are skipped,
    # every parameter and moment bit-equal, the scale halving, until the
    # gradients are finite
    scaler = paddle.amp.GradScaler(init_loss_scaling=AMP_F16_INIT_SCALE)
    step = amp_step_fn(paddle, clf, opt, batches, "O1", "float16", scaler,
                       grads_f32=True)
    before = params_and_moments(clf, opt)
    skipped = 0
    while True:
        scale = scaler.get_loss_scaling()
        step()
        if not scaler.last_step_skipped():
            break
        skipped += 1
        check(scaler.get_loss_scaling() == max(scale / 2, 1.0),
              f"f16 O1: a skipped step took the scale {scale} to "
              f"{scaler.get_loss_scaling()}, not half")
        check(all(torch.equal(a, b) for a, b in zip(
            before, params_and_moments(clf, opt))),
            f"f16 O1: skipped step {skipped} changed a parameter or moment")
        check(skipped <= AMP_SKIP_MAX, f"f16 O1: {skipped} steps skipped")
    del before
    check(skipped > 0, "f16 O1: no step overflowed at a scale of 2^40")
    log(f"f16 O1: {skipped} steps skipped, scale "
        f"{AMP_F16_INIT_SCALE:g} -> {scaler.get_loss_scaling():g}")
    f16_launches, f16_losses, f16_applied = amp_launches(
        step, AMP_CHECK_STEPS, "float16", scaler, "f16 O1")
    f16 = amp_timing(step, n_params, "fine-tuning, O1 float16")
    out = {"train": "bert_base_finetune_eager_amp_o1", "batch": FT_BATCH,
           "seq_len": FT_SEQ, "layers": BERT_LAYERS, "params": n_params,
           "f32_step1_loss": f32_loss, "bf16_step1_loss": amp_loss,
           "step1_loss_rel": rel, "bf16": {**bf16, "losses": bf16_losses,
                                           "launches": bf16_launches},
           "f16": {**f16, "losses": f16_losses, "launches": f16_launches,
                   "applied_of_checked": f16_applied,
                   "skipped_steps": skipped, "init_loss_scaling":
                   AMP_F16_INIT_SCALE, "loss_scaling":
                   scaler.get_loss_scaling()},
           "f32_phase21": {k: ft[k] for k in ("step_ms_median",
                                              "samples_per_s", "mfu")}}
    log(json.dumps({"bert_finetune_amp": out}))
    del clf, opt, batches
    torch.cuda.empty_cache()
    return out


def o2_phase(dev):
    """Phase 27 (the module docstring): ``decorate(level="O2")``."""
    import os
    import tempfile
    import paddle1_tpu_torch as paddle
    out = {}
    for dtype in ("bfloat16", "float16"):
        clf, opt, _, batches, _ = ft_setup(paddle)
        clf, opt = paddle.amp.decorate(clf, opt, level="O2", dtype=dtype)
        dt = getattr(torch, dtype)
        check({p.dtype for p in clf.parameters()} == {dt},
              f"O2 {dtype}: the parameters are not {dtype}")
        scaler = paddle.amp.GradScaler() if dtype == "float16" else None
        step = amp_step_fn(paddle, clf, opt, batches, "O2", dtype, scaler)
        skipped = 0
        while scaler is not None:    # until the scale lets a step apply
            step()
            if not scaler.last_step_skipped():
                break
            skipped += 1
            check(skipped <= AMP_SKIP_MAX, f"O2 {dtype}: {skipped} steps "
                  "skipped")
        launches, losses, applied = amp_launches(
            step, AMP_CHECK_STEPS, dtype, scaler, f"O2 {dtype}")
        check({p.dtype for p in clf.parameters()} == {dt} and all(
            t.dtype == torch.float32 for s in opt._slots.values()
            for t in s.values()), f"O2 {dtype}: row 6 did not update "
            f"{dtype} parameters with float32 moments")
        timing = amp_timing(step, sum(p.nelement() for p in
                                      clf.parameters()), f"fine-tuning, O2 "
                            f"{dtype}")
        # a save/load resume of model, optimizer and scaler repeats the
        # next step bit for bit
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "o2.pdckpt")
            paddle.save({"model": clf.state_dict(), "opt": opt.state_dict(),
                         "scaler": scaler.state_dict() if scaler else {}},
                        path)
            ck = paddle.load(path)
        fresh = ft_classifier(paddle, BERT_LAYERS, SEED + 270, 0.1)
        fopt, _, _ = ft_optimizer(paddle, fresh)
        fresh, fopt = paddle.amp.decorate(fresh, fopt, level="O2",
                                          dtype=dtype)
        fmissing, funexpected = fresh.set_state_dict(ck["model"])
        fopt.set_state_dict(ck["opt"])
        fscaler = None
        if scaler is not None:
            fscaler = paddle.amp.GradScaler()
            fscaler.load_state_dict(ck["scaler"])
        del ck
        check(fmissing == [] and funexpected == [], f"O2 {dtype} resume: "
              f"missing {fmissing}, unexpected {funexpected}")
        fresh.train()
        on, resumed = [], []
        for model, o, sc_, acc in ((clf, opt, scaler, on),
                                   (fresh, fopt, fscaler, resumed)):
            torch.manual_seed(SEED + 271)
            acc.append(float(amp_step_fn(paddle, model, o, batches[:1], "O2",
                                         dtype, sc_)()))
        equal = on == resumed and all(torch.equal(a, b) for a, b in zip(
            clf.parameters(), fresh.parameters()))
        check(equal, f"O2 {dtype}: a step after save/load differs from the "
              f"uninterrupted run: {on} vs {resumed}")
        out[dtype] = {**timing, "losses": losses, "launches": launches,
                      "applied_of_checked": applied,
                      "skipped_before": skipped,
                      "loss_scaling": scaler.get_loss_scaling()
                      if scaler else None,
                      "resume_loss": [on[0], resumed[0]],
                      "resume_bit_identical": equal}
        del clf, opt, fresh, fopt, batches
        torch.cuda.empty_cache()
    log(json.dumps({"bert_finetune_o2": out}))
    return out


# ---------------------------------------------------------------------------
# phase 28: the nn slice's functionals and layers on the card

def nn_cases():
    """``tests/test_torch_nn_cases.py`` (no JAX), loaded by path after
    ``tests/test_torch_op_cases.py``, which it imports."""
    import importlib.util
    import os
    op_cases()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_nn_cases.py")
    spec = importlib.util.spec_from_file_location("test_torch_nn_cases",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def nn_layer_run(paddle, cases, case, place, state=None):
    """``case``'s layer built under ``place`` (its state ``state`` when
    given: the CPU layer's before its call), called on the case's arrays:
    ``(output, gradients of the listed arguments, {name: parameter
    gradient}, state after the call, state before it)``."""
    with paddle.device_guard(place):
        def t(v):
            if callable(v):      # a layer argument (cases.make)
                return v(paddle.nn)
            return paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
        with paddle.utils.unique_name.guard():
            layer = getattr(paddle.nn, case.op)(
                *[t(a) for a in case.ctor],
                **{k: t(v) for k, v in case.ctor_kw.items()})
        if state is not None:
            layer.load_state_dict(state)
        layer.train() if case.train else layer.eval()
        before = {k: v.detach().clone()
                  for k, v in layer.state_dict().items()}
        args = [op_tensors(paddle, a, i in case.grad)
                for i, a in enumerate(case.args)]
        kw = {k: op_tensors(paddle, v, False) for k, v in case.kw.items()}
        out = layer(*args, **kw)
        first = op_leaves(out)[0]     # a recurrent layer's output sequence
        w = cases.R(tuple(first.shape), 99)
        (first * paddle.to_tensor(w)).sum().backward()
        grads = [args[i].grad for i in case.grad]
        pgrads = {k: p.grad for k, p in layer.named_parameters()}
        return out, grads, pgrads, layer.state_dict(), before


# the optimizers phase 28 steps on the card against the CPU: each name the
# port added, with its constructor's keywords (weight decay where it takes
# one), a global-norm clip and a StepDecay schedule
NN_OPTIMIZERS = (("SGD", {"weight_decay": 0.01}),
                 ("Lars", {"lars_coeff": 0.01, "weight_decay": 0.01}),
                 ("Ftrl", {"l1": 0.01, "l2": 0.02, "weight_decay": 0.01}),
                 ("Adagrad", {"initial_accumulator_value": 0.1,
                              "weight_decay": 0.01}),
                 ("Adamax", {"weight_decay": 0.01}),
                 ("AdaDelta", {"rho": 0.9, "weight_decay": 0.01}),
                 ("Adadelta", {"epsilon": 1e-5}),
                 ("RMSProp", {"momentum": 0.9, "centered": True,
                              "weight_decay": 0.01}),
                 ("Lamb", {"lamb_weight_decay": 0.05}))
NN_OPT_TOL = 1e-5    # the CPU tests' (tests/test_torch_optimizers.py)


def optimizer_run(paddle, name, kw, place, state=None):
    """Three steps of ``optimizer.<name>`` (a global-norm clip at 0.5, a
    StepDecay schedule) over a small net built under ``place`` (its state
    ``state`` when given), on seeded batches: the parameters after each
    step, and the net's state before the first."""
    nn = paddle.nn
    with paddle.device_guard(place):
        with paddle.utils.unique_name.guard():
            net = nn.Sequential(nn.Linear(8, 16), nn.Tanh(),
                                nn.Linear(16, 4))
        if state is not None:
            net.load_state_dict(state)
        before = {k: v.detach().clone() for k, v in net.state_dict().items()}
        sched = paddle.optimizer.lr.StepDecay(0.05, step_size=1, gamma=0.5)
        opt = getattr(paddle.optimizer, name)(
            learning_rate=sched, parameters=net.parameters(),
            grad_clip=nn.ClipGradByGlobalNorm(0.5), **kw)
        out = []
        for k in range(3):
            rng = np.random.default_rng(SEED + 150 + k)
            x = paddle.to_tensor(rng.standard_normal((6, 8)).astype(
                np.float32))
            y = paddle.to_tensor(rng.standard_normal((6, 4)).astype(
                np.float32))
            d = net(x) - y
            (d * d).mean().backward()
            opt.step()
            sched.step()
            opt.clear_grad()
            out.append([p.detach().clone() for p in net.parameters()])
        return out, before


def optimizer_cases_on_card(paddle, card, cases):
    """Each of NN_OPTIMIZERS three steps on the card against the CPU from
    the same weights, at OPS_TOL_SCALE x the CPU tolerance: the failures,
    listed."""
    failed = []
    tol = NN_OPT_TOL * OPS_TOL_SCALE
    for name, kw in NN_OPTIMIZERS:
        try:
            want, state = optimizer_run(paddle, name, kw, "cpu")
            got, _ = optimizer_run(paddle, name, kw, card, state)
            for step, (w, g) in enumerate(zip(want, got)):
                op_compare(cases, w, g, tol)
        except Exception as e:   # noqa: BLE001  (every failure listed)
            failed.append(f"optimizer.{name}: {type(e).__name__}: "
                          f"{str(e).strip()[:300]}")
    return failed


def nn_phase(dev):
    """Phase 28 (the module docstring): every case of
    ``tests/test_torch_nn_cases.py`` on the card against the CPU, and
    three steps of each optimizer of NN_OPTIMIZERS."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.nn import functional as F
    from paddle1_tpu_torch.nn import (layer_common, layer_conv_pool,
                                      layer_loss, layer_norm_act, layer_rnn)
    from paddle1_tpu_torch.nn.functional import (activation, common, conv,
                                                 crf, loss, norm, pooling)
    cases = nn_cases()
    card = f"gpu:{dev.index or 0}"
    counters = bn_counters()
    zero(counters)
    failed, n_cases, names = [], 0, set()
    t0 = time.perf_counter()
    for group, case in cases.all_cases():
        tol = max(case.tol * OPS_TOL_SCALE, OPS_TOL_MIN)
        n_cases += 1
        names.add(case.op)
        try:
            if group == "F":
                fn = getattr(F, case.op)
                want = op_run(paddle, cases, case, fn, "cpu")
                got = op_run(paddle, cases, case, fn, card)
                for w, g in zip(want, got):
                    op_compare(cases, w, g, tol)
            else:
                want = nn_layer_run(paddle, cases, case, "cpu")
                got = nn_layer_run(paddle, cases, case, card, want[4])
                op_compare(cases, want[0], got[0], tol)
                op_compare(cases, want[1], got[1], tol)
                check(sorted(want[2]) == sorted(got[2]),
                      "parameters differ")
                for k, g in want[2].items():
                    check((g is None) == (got[2][k] is None),
                          f"{k}: a gradient on one device only")
                    if g is not None:
                        op_compare(cases, g, got[2][k], tol)
                for k, v in want[3].items():
                    op_compare(cases, v, got[3][k], tol)
        except Exception as e:   # noqa: BLE001  (every failure listed)
            failed.append(f"{group}.{case.name()}: {type(e).__name__}: "
                          f"{str(e).strip()[:300]}")
    launches = bn_launches(counters)
    for name, draw in cases.RANDOM:
        names.add(name)
        try:
            g1 = torch.Generator(dev).manual_seed(5)
            g2 = torch.Generator(dev).manual_seed(5)
            with paddle.device_guard(card):
                first = draw(F, paddle.to_tensor, generator=g1)
                again = draw(F, paddle.to_tensor, generator=g2)
            check(first.device.type == CARD, f"{name} did not draw on the "
                  "card")
            check(torch.equal(first, again), f"{name} does not repeat "
                  "under a generator")
            cases.random_check(name, first.detach().cpu().numpy())
        except Exception as e:   # noqa: BLE001
            failed.append(f"random {name}: {type(e).__name__}: "
                          f"{str(e)[:300]}")
    # RNNCellBase: the cells' abstract base, whose get_initial_states
    # every cell case runs
    containers = {"Sequential", "LayerList", "ParameterList", "LayerDict",
                  "collect_stat_updates", "fused_bn_active", "RNNCellBase"}
    ported = set()
    for m in (activation, norm, loss, common, pooling, conv, crf,
              layer_norm_act, layer_loss, layer_common, layer_conv_pool,
              layer_rnn):
        ported |= set(m.__all__)
    uncovered = sorted(ported - names - containers)
    if uncovered:
        failed.append(f"names without a case on the card: {uncovered}")
    failed += optimizer_cases_on_card(paddle, card, cases)
    # the batch norms among the cases ran the kernels, the affine-less
    # ones (F18) included
    for k in ("fused_bn_train", "fused_bn_norm", "fused_bn_train_bwd"):
        if not launches[k]:
            failed.append(f"the batch-norm cases launched no {k}")
    torch.cuda.synchronize()
    out = {"nn_cases": {
        "names": len(names), "cases": n_cases,
        "random": len(cases.RANDOM), "bn_launches": launches,
        "optimizers": [n for n, _ in NN_OPTIMIZERS],
        "seconds": time.perf_counter() - t0, "failed": failed}}
    log(json.dumps(out))
    check(not failed, f"the nn slice failed {len(failed)} checks on the "
          f"card: {failed[:5]}")
    return out


# ---------------------------------------------------------------------------
# phase 29: MobileNetV2 ImageNet training and eval (the tenth main path)

# Sandler et al. 2018: batch 96 at 3 x 224², the optimizer's rate 0.045,
# weight decay 4e-5 (their RMSProp replaced by Momentum 0.9: the port has
# no RMSProp yet); 52 batch norms
MN_BATCH, MN_IMG, MN_LR, MN_MOMENTUM, MN_DECAY, MN_BNS = \
    96, 224, 0.045, 0.9, 4e-5, 52
MN_PARAMS, MN_STEPS, MN_BF16_STEPS = 3504872, 8, 3
# rows 8, 9 and 11 timed at four of its shapes in f32: the stem, the
# narrowest C at the widest rows, an expansion at 14², the last 1 x 1
MN_BN_TIMED = ((1204224, 32), (1204224, 16), (18816, 576), (4704, 1280))
# its f32 kernel-vs-plain check, as ResNet-50's (mobilenet_reference_check):
# full depth at batch 16 x 224², the depth cut to the first block of each
# stage at 32 x 64² at MN_REF_SEEDS seeds (the first with three Momentum
# steps at RN_LR); the classifier's dropout 0 in both paths
MN_REF_FULL = {"batch": 16, "img": 224}
MN_REF_CUT = {"batch": 32, "img": 64, "first_blocks": True}
MN_REF_SEEDS = 4
# the zero-gradient floor of the gaps: each parameter's error over its
# float64 gradient, at least this share of the largest's (the projections'
# batch-norm biases have a zero gradient in exact arithmetic)
MN_GAP_FLOOR = 1e-3


def mn_model(dev, seed, first_blocks=False, dropout=True):
    """``mobilenet_v2()`` with seeded weights on ``dev``; with
    ``first_blocks`` the depth cut to the first inverted-residual block of
    each of its seven stages (22 batch norms)."""
    from paddle1_tpu_torch.nn import Sequential
    from paddle1_tpu_torch.vision.models import mobilenet_v2
    m = mobilenet_v2(device=dev, generator=torch.Generator().manual_seed(
        seed))
    if first_blocks:
        keep, blocks = [m.features[0]], m.features[1:-1]
        for b in blocks:
            # a stage's first block changes the width or the stride
            first = b.stride != 1 or not b.use_res_connect
            if first:
                keep.append(b)
        keep.append(m.features[-1])
        m.features = Sequential(*keep)
    if not dropout:
        m.classifier[0].p = 0.0
    return m


def mn_batches(paddle, n, batch, img, seed):
    rng = np.random.default_rng(seed)
    return [(paddle.to_tensor(rng.standard_normal(
                 (batch, 3, img, img)).astype(np.float32)),
             paddle.to_tensor(rng.integers(0, 1000, (batch,))))
            for _ in range(n)]


def mn_loop(paddle, model, lr=MN_LR):
    """The eager training step of the path: ``nn.CrossEntropyLoss()`` of
    the model's logits, ``loss.backward()``, ``opt.step()``,
    ``opt.clear_grad()``; Momentum with the L2 decay."""
    opt = paddle.optimizer.Momentum(
        lr, MN_MOMENTUM, parameters=model.parameters(),
        weight_decay=paddle.regularizer.L2Decay(MN_DECAY))
    crit = paddle.nn.CrossEntropyLoss()

    def step(x, y):
        loss = crit(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return opt, step


def mn_loss_fn(m, b):
    from paddle1_tpu_torch import nn
    return nn.CrossEntropyLoss()(m(b["x"]), b["y"])


def mn_eager_steps(model, data, steps):
    """``steps`` eager Momentum steps of the path's loop (:func:`mn_loop`,
    lr RN_LR) on one batch; returns the losses."""
    import paddle1_tpu_torch as paddle
    _, step = mn_loop(paddle, model, RN_LR)
    return [float(step(data["x"], data["y"])) for _ in range(steps)]


def mn_reference_readings(dev, batch, img, first_blocks=False, steps=0,
                          seed=0):
    """:func:`reference_readings` of MobileNetV2 (``first_blocks``: the
    depth cut), seeded weights and data (``seed`` apart from the first),
    dropout 0, eager steps (:func:`mn_eager_steps`), its ReLU6 gradients
    also taken on float64's pieces."""
    model = mn_model(dev, SEED + 120 + seed, first_blocks, dropout=False)
    return reference_readings(dev, model, SEED + 121 + seed, batch, img,
                              mn_eager_steps, steps, loss_fn=mn_loss_fn,
                              floor=MN_GAP_FLOOR, pieces=True,
                              seed=SEED + 120 + seed,
                              first_blocks=first_blocks, lr=RN_LR)


def mobilenet_reference_check(dev):
    """The f32 kernel path against the plain path, by ResNet-50's checks
    (:func:`reference_check`) with one change: the two paths' first-step
    gradients are compared with the gradients of their ReLU6s taken on
    float64's side of each kink (``kernel_same_piece_vs_plain_same_piece``
    within RN_GRAD_TOL), on the depth cut at MN_REF_SEEDS seeds and at
    full depth. Where a pre-activation lies within an f32 rounding of 0
    or 6, either f32 path may put it on the other side from float64, and
    the gradient of every parameter before it moves by about one
    element's share of the sum: 1e-4 to 8e-3 on this cut by seed, 1e-2 at
    full depth (PERF.md §6). The paths' own gradients, and the elements
    each puts on the other side by layer, are printed."""
    full = mn_reference_readings(dev, **MN_REF_FULL)
    cuts = [mn_reference_readings(dev, steps=REF_STEPS if i == 0 else 0,
                                  seed=i, **MN_REF_CUT)
            for i in range(MN_REF_SEEDS)]
    log(json.dumps({"mobilenet_v2_reference": {"full_depth": full,
                                               "depth_cuts": cuts}}))
    for r in cuts:
        g = r["grads"]
        log(f"mobilenet depth cut, seed {r['seed']}: first-step gradients "
            f"kernel vs plain {g['gaps']['kernel_vs_plain']['max']:.3g}, "
            f"on float64's pieces "
            f"{g['gaps']['kernel_same_piece_vs_plain_same_piece']['max']:.3g}"
            f"; elements off float64's piece: kernel "
            f"{g['flips']['kernel']['layers']}, plain "
            f"{g['flips']['plain']['layers']}")
    reference_check("mobilenet", full, cuts)
    return full, cuts


def mobilenet_phase(dev):
    """Phase 29 (the module docstring): eager MobileNetV2 training at
    batch 96 x 224² in f32, eval, save/load, a bf16 engine run, the
    kernel-vs-plain check."""
    import tempfile
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.nn import BatchNorm2D
    from paddle1_tpu_torch.nn import functional as F
    from paddle1_tpu_torch.ops import softmax as psm
    t0 = time.perf_counter()
    model = mn_model(dev, SEED + 110)
    n_params = sum(p.nelement() for p in model.parameters())
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2D)]
    widths = sorted({b._num_features for b in bns})
    check(n_params == MN_PARAMS and len(bns) == MN_BNS,
          f"mobilenet_v2: {n_params} parameters, {len(bns)} batch norms")
    check(all(t.device.type == CARD for t in model.state_dict().values()),
          "mobilenet_v2 did not default to the card")
    opt, step_fn = mn_loop(paddle, model)
    batches = mn_batches(paddle, 2, MN_BATCH, MN_IMG, SEED + 111)
    it = [0]

    def step():
        it[0] += 1
        return step_fn(*batches[it[0] % 2])
    torch.cuda.reset_peak_memory_stats()
    first = [float(step_fn(*batches[0])), float(step_fn(*batches[1]))]
    setup_s = time.perf_counter() - t0
    counters = bn_counters()
    counters["softmax"] = psm.fused_softmax
    zero(counters)
    it[0] = 1
    slopes, _, steps = timed_steps(step, MN_STEPS)
    torch.cuda.synchronize()
    train = bn_launches(counters)
    want = {"fused_bn_train": MN_BNS * steps, "fused_bn_norm": 0,
            "fused_bn_train_bwd": MN_BNS * steps, "fused_bn_norm_bwd": 0,
            "softmax": 0}
    check(train == want, f"mobilenet training launches {train}, want "
          f"{want} ({steps} steps)")
    peak = torch.cuda.max_memory_allocated()
    prof = device_kernels_per_step(step, 2)
    last = [float(step_fn(*batches[0])), float(step_fn(*batches[1]))]
    check(all(np.isfinite(first + last)), f"mobilenet: non-finite loss "
          f"{first} {last}")
    check(sum(last) < sum(first), f"mobilenet: the loss did not fall over "
          f"the cycled batches: {first} -> {last}")
    dt = float(np.median(slopes))
    busy = prof["device_busy_ms_per_step"]

    # eval: the running statistics on row 9, the top-1 through row 7
    model.eval()
    x0 = batches[0][0]
    with paddle.no_grad():
        model(x0)                                 # warm
        torch.cuda.synchronize()
        zero(counters)
        ta = time.perf_counter()
        logits = model(x0)
        probs = F.softmax(logits)
        top1 = paddle.argmax(probs, axis=-1)
        top1_np = top1.numpy()
        eval_ms = (time.perf_counter() - ta) * 1e3
    evals = bn_launches(counters)
    want = {"fused_bn_train": 0, "fused_bn_norm": MN_BNS,
            "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": 0, "softmax": 1}
    check(evals == want, f"mobilenet eval launches {evals}, want {want}")
    check(logits.shape == [MN_BATCH, 1000] and
          bool(torch.isfinite(logits).all()) and
          float((probs.sum(-1) - 1).abs().max()) < 1e-5 and
          np.array_equal(top1_np, torch.argmax(logits, -1).cpu().numpy()),
          "mobilenet eval: logits, probabilities or top-1 wrong")
    eval_times = []
    with paddle.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            ta = time.perf_counter()
            model(x0)
            torch.cuda.synchronize()
            eval_times.append((time.perf_counter() - ta) * 1e3)
    # the [rows, C] each batch norm gets on the path: 19 pairs
    bn_shapes = sorted(set(bn_input_shapes(model, x0)), reverse=True)

    # save -> load into a fresh model: the eval bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mobilenet_v2.pdparams"
        paddle.save(model.state_dict(), path)
        fresh = mn_model(dev, SEED + 119)
        missing, unexpected = fresh.set_state_dict(paddle.load(path))
    fresh.eval()
    with paddle.no_grad():
        again = fresh(x0)
    check(missing == [] and unexpected == [] and torch.equal(again, logits),
          f"mobilenet: the eval after save/load differs (missing "
          f"{missing}, unexpected {unexpected})")
    del fresh, again

    # the same model in bf16 through the engine (rows 8 and 11 in bf16)
    bmodel = mn_model(dev, SEED + 112)
    eng = ParallelEngine(
        bmodel, paddle.optimizer.Momentum(
            MN_LR, MN_MOMENTUM, parameters=bmodel.parameters(),
            weight_decay=paddle.regularizer.L2Decay(MN_DECAY)),
        mn_loss_fn, amp_dtype="bfloat16")
    staged = [{"x": x, "y": y} for x, y in batches]
    float(eng.step(staged[0]))
    zero(counters)
    tb = time.perf_counter()
    bf16_losses = [float(eng.step(staged[i % 2]))
                   for i in range(MN_BF16_STEPS)]
    bf16_ms = (time.perf_counter() - tb) * 1e3 / MN_BF16_STEPS
    bf16 = bn_launches(counters)
    want = {"fused_bn_train": MN_BNS * MN_BF16_STEPS, "fused_bn_norm": 0,
            "fused_bn_train_bwd": MN_BNS * MN_BF16_STEPS,
            "fused_bn_norm_bwd": 0, "softmax": 0}
    check(bf16 == want and all(np.isfinite(bf16_losses)),
          f"mobilenet bf16 engine: launches {bf16} (want {want}), losses "
          f"{bf16_losses}")
    del eng, bmodel, staged

    summary = {
        "train": "mobilenet_v2_eager", "dtype": "float32", "tf32": False,
        "batch": MN_BATCH, "img": MN_IMG, "params": n_params,
        "batch_norms": len(bns), "bn_widths": widths,
        "optimizer": f"Momentum({MN_LR}, {MN_MOMENTUM}, "
                     f"weight_decay=L2Decay({MN_DECAY}))",
        "setup_s": setup_s, "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3, "images_per_s": MN_BATCH / dt,
        "loss_first": first, "loss_last": last,
        "peak_mem_gb": peak / 1e9, "launches_train": train,
        "launches_per_step": {k: n / steps for k, n in train.items()},
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / (dt * 1e3),
        "profiler_window_idle_share": 1.0 - busy / prof["profiled_step_ms"],
        "bn_kernels_ms_per_step": prof["bn_ms_per_step"],
        "bn_share_of_busy": prof["bn_ms_per_step"] / busy,
        "eval_ms_first_timed": eval_ms,
        "eval_forward_ms_median": float(np.median(eval_times)),
        "launches_eval": evals, "eval_top1_agrees_with_argmax": True,
        "save_load_eval_bit_identical": True,
        "bf16_engine": {"steps": MN_BF16_STEPS, "losses": bf16_losses,
                        "step_ms": bf16_ms, "launches": bf16},
        "profile": prof}
    log(json.dumps({"mobilenet_v2": summary}))
    log(f"mobilenet_v2 f32 batch {MN_BATCH} x {MN_IMG}²: step "
        f"{dt * 1e3:.2f} ms, {MN_BATCH / dt:.1f} images/s, busy "
        f"{busy:.2f} ms, idle {summary['device_idle_share']:.3f}, batch "
        f"norms {summary['bn_share_of_busy']:.3f} of busy, eval forward "
        f"{summary['eval_forward_ms_median']:.2f} ms, peak "
        f"{peak / 1e9:.2f} GB ({card_line()})")
    del model, opt, batches
    torch.cuda.empty_cache()
    # rows 8, 9, 11 (and 12) against their plain versions at those shapes
    errs = bn_check(dev, bn_shapes, acts=("identity",), residuals=(False,))
    times = bn_timing(dev, MN_BN_TIMED, MN_BATCH, torch.float32)
    mobilenet_reference_check(dev)
    torch.cuda.empty_cache()
    summary["bn_check"] = {"shapes": bn_shapes, "max_abs_err": {
        k: max(e["max_abs_err"] for e in v) for k, v in errs.items()}}
    log(json.dumps({"mobilenet_v2_bn_check": summary["bn_check"]}))
    summary["bn_times_f32"] = times
    return summary


# ---------------------------------------------------------------------------
# phases 30-31: Transformer-base training and beam search (the eleventh main
# path). The model is a user script over the Paddle API: the functions
# below take the package as ``paddle`` and run on the JAX package too
# (``tests/test_torch_transformer.py`` holds a narrow twin to it).

# Vaswani et al. 2017, "base" (Table 3): d_model 512, 8 heads, 6 + 6
# layers, feed-forward 2048, dropout 0.1 on the sublayer outputs and the
# embedding sums (§5.4), label smoothing 0.1, Adam(0.9, 0.98, 1e-9) on the
# Noam schedule with 4000 warm-up steps (§5.3); one shared ~37000-token
# BPE vocabulary for the source, the target and the output projection
# (§3.4, §5.1). Token ids: 0 pad, 1 begin, 2 end.
TF_VOCAB, TF_D, TF_HEADS, TF_LAYERS, TF_FFN, TF_DROPOUT = \
    37000, 512, 8, 6, 2048, 0.1
TF_PAD, TF_BOS, TF_EOS = 0, 1, 2
TF_SMOOTH, TF_WARMUP, TF_BETA1, TF_BETA2, TF_EPS = 0.1, 4000, 0.9, 0.98, 1e-9
TF_MAX_LEN = 512


def s2s_sinusoid(n, d):
    """The sinusoidal positions ``[n, d]`` (§3.5): sin on the even
    features, cos on the odd, wavelengths 2 pi .. 10000 * 2 pi."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    ang = pos / np.power(10000.0, np.arange(0, d, 2) / d)[None, :]
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2], pe[:, 1::2] = np.sin(ang), np.cos(ang)
    return pe


def s2s_model(paddle, vocab=TF_VOCAB, d_model=TF_D, nhead=TF_HEADS,
              enc_layers=TF_LAYERS, dec_layers=TF_LAYERS, ffn=TF_FFN,
              dropout=TF_DROPOUT):
    """The translation model of the user script: ``nn.Transformer``
    (post-norm, attention and activation dropout 0, so the flash kernels
    can take the encoder's and the cross-attention) between one shared
    ``nn.Embedding(vocab, d_model, padding_idx=0)``, scaled by
    sqrt(d_model) and summed with the sinusoidal positions, and the output
    projection onto the same embedding; dropout ``dropout`` on the
    embedding sums and the sublayer outputs."""
    nn = paddle.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.d_model = d_model
            self.embedding = nn.Embedding(
                vocab, d_model, padding_idx=TF_PAD,
                weight_attr=paddle.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, d_model ** -0.5)))
            self.transformer = nn.Transformer(
                d_model, nhead, enc_layers, dec_layers, ffn, dropout=dropout,
                attn_dropout=0.0, act_dropout=0.0)
            self.dropout = nn.Dropout(dropout)
            self.pos = paddle.to_tensor(s2s_sinusoid(TF_MAX_LEN, d_model))

        def embed(self, ids, start=0):
            n = ids.shape[1]
            x = self.embedding(ids) * self.d_model ** 0.5 + \
                self.pos[start:start + n]
            return self.dropout(x)

        def project(self, h):
            return paddle.matmul(h, self.embedding.weight, transpose_y=True)

        def forward(self, src, tgt, src_mask=None, tgt_mask=None):
            memory = self.transformer.encoder(self.embed(src), src_mask)
            return self.project(self.transformer.decoder(
                self.embed(tgt), memory, tgt_mask, src_mask))

    return Seq2Seq()


def s2s_batch(paddle, model, rng, batch, src_len, tgt_len, vocab=TF_VOCAB):
    """One seeded token bucket as Paddle tensors on the current place:
    sources of ragged real length in (src_len / 2, src_len] (row 0 full),
    padded with 0 to ``src_len``, a multiple of 128 (the flash kernels
    take no ragged tail, ``ops/flash_attention.py:supported``); targets a
    fixed token map of each source's first ``min(len, tgt_len - 1)``
    tokens (a synthetic translation a model can learn), fed as [1, y] and
    scored as [y, 2], padded to ``tgt_len``. ``src_mask`` is the
    ``[B, 1, 1, Ns]`` keep-mask, the form the flash kernels take; the
    target's is the causal ``[Nt, Nt]`` mask."""
    ls = rng.integers(src_len // 2 + 1, src_len + 1, batch)
    ls[0] = src_len
    src = rng.integers(3, vocab, (batch, src_len))
    src[np.arange(src_len)[None, :] >= ls[:, None]] = TF_PAD
    lt = np.minimum(ls, tgt_len - 1)
    y = (src[:, :tgt_len - 1] * 7 + 11) % (vocab - 3) + 3
    tgt_in = np.full((batch, tgt_len), TF_PAD, np.int64)
    tgt_out = np.full((batch, tgt_len), TF_PAD, np.int64)
    for i, n in enumerate(lt):
        tgt_in[i, 0], tgt_in[i, 1:n + 1] = TF_BOS, y[i, :n]
        tgt_out[i, :n], tgt_out[i, n] = y[i, :n], TF_EOS
    return {"src": paddle.to_tensor(src.astype(np.int64)),
            "tgt_in": paddle.to_tensor(tgt_in),
            "tgt_out": paddle.to_tensor(tgt_out),
            "src_mask": paddle.to_tensor((src != TF_PAD)[:, None, None, :]),
            "tgt_mask": model.transformer.generate_square_subsequent_mask(
                tgt_len),
            "tokens": int((tgt_out != TF_PAD).sum())}


def s2s_loss(paddle, logits, tgt_out, vocab=TF_VOCAB, epsilon=TF_SMOOTH):
    """Label-smoothed cross entropy over the real target tokens: the
    one-hot targets smoothed by ``epsilon``, the per-token soft-label
    losses masked at the pad id and averaged."""
    F = paddle.nn.functional
    soft = F.label_smooth(F.one_hot(tgt_out, vocab), epsilon=epsilon)
    ce = F.cross_entropy(logits, soft, soft_label=True, reduction="none")
    keep = (tgt_out != TF_PAD).astype("float32")
    return (ce.reshape(keep.shape) * keep).sum() / keep.sum()


def s2s_optimizer(paddle, model, d_model=TF_D, warmup=TF_WARMUP):
    """``Adam(0.9, 0.98, 1e-9)`` on ``lr.NoamDecay(d_model, warmup)``."""
    sched = paddle.optimizer.lr.NoamDecay(d_model=d_model,
                                          warmup_steps=warmup)
    opt = paddle.optimizer.Adam(learning_rate=sched, beta1=TF_BETA1,
                                beta2=TF_BETA2, epsilon=TF_EPS,
                                parameters=model.parameters())
    return opt, sched


def s2s_step_fn(paddle, model, opt, sched, batches, amp=True,
                vocab=TF_VOCAB):
    """One eager training step over the batches in turn, under
    ``amp.auto_cast()`` (bf16 O1) when ``amp``: ``loss.backward();
    opt.step(); sched.step(); opt.clear_grad()``."""
    turn = [0]

    def step():
        b = batches[turn[0] % len(batches)]
        turn[0] += 1
        with paddle.amp.auto_cast(enable=amp):
            logits = model(b["src"], b["tgt_in"], b["src_mask"],
                           b["tgt_mask"])
            loss = s2s_loss(paddle, logits, b["tgt_out"], vocab)
        loss.backward()
        opt.step()
        sched.step()
        opt.clear_grad()
        return loss
    return step


class S2SCell:
    """The decode cell of the user script: token ids ``[B * beam]`` and
    the decoder's caches ``[(Cache, StaticCache)] * L`` → the next
    token's logits ``[B * beam, vocab]`` and the grown caches. The
    position is the self-attention cache's length; the cross-attention
    reads the memory's projections from the StaticCache."""

    def __init__(self, model, memory, memory_mask):
        self.model, self.memory, self.memory_mask = model, memory, memory_mask

    def __call__(self, ids, caches):
        t = caches[0][0].k.shape[1]
        x = self.model.embed(ids.reshape([-1, 1]), start=t)
        h, caches = self.model.transformer.decoder(
            x, self.memory, None, self.memory_mask, caches)
        return self.model.project(h[:, -1]), caches


def s2s_decode(paddle, model, src, src_mask, beam=4, max_step_num=None,
               beam_decoder=None, end_token=TF_EOS):
    """Beam search (``beam`` > 1) or greedy decoding (``beam`` = 1 through
    ``BasicDecoder`` and ``GreedyEmbeddingHelper``) in eval mode under
    ``no_grad``: the encoder once, then ``dynamic_decode`` with
    incremental ``Cache`` self-attention and ``StaticCache``
    cross-attention. Returns the token ids, ``[B, T, beam]`` for beam
    search (the final beams, best first) or ``[B, T]``. ``beam_decoder``:
    the beam-search class (``nn.BeamSearchDecoder`` when None);
    ``end_token``: the id that ends a sentence."""
    nn = paddle.nn
    model.eval()
    with paddle.no_grad():
        memory = model.transformer.encoder(model.embed(src), src_mask)
        caches = model.transformer.decoder.gen_cache(memory)
        if beam == 1:
            cell = S2SCell(model, memory, src_mask)
            helper = nn.GreedyEmbeddingHelper(
                lambda ids: ids,
                np.full([int(src.shape[0])], TF_BOS, np.int64), end_token)
            out, _ = nn.dynamic_decode(nn.BasicDecoder(cell, helper),
                                       inits=caches,
                                       max_step_num=max_step_num)
            ids = out.sample_ids
        else:
            tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
            cell = S2SCell(model, tile(memory, beam), tile(src_mask, beam))
            dec = (beam_decoder or nn.BeamSearchDecoder)(cell, TF_BOS,
                                                         end_token, beam)
            ids, _ = nn.dynamic_decode(dec, inits=caches,
                                       max_step_num=max_step_num)
    model.train()
    return ids


def s2s_eval_loss(paddle, model, batches, vocab=TF_VOCAB):
    """The mean loss over ``batches`` in eval mode (no dropout) and f32,
    under ``no_grad``; the model goes back to training mode."""
    model.eval()
    with paddle.no_grad():
        losses = [float(s2s_loss(paddle, model(
            b["src"], b["tgt_in"], b["src_mask"], b["tgt_mask"]),
            b["tgt_out"], vocab)) for b in batches]
    model.train()
    return float(np.mean(losses))


# the smoke's cells of the path: two token buckets of about 4096 target
# tokens each, (batch, padded source, padded target); the f32 check's
# buckets at depth 2 + 2; beam search over 32 sources of the 128 bucket
# with the paper's beam 4 and length limit (source length + 50, §6.1)
TF_BUCKETS = ((32, 128, 128), (16, 256, 128))
TF_STEPS = 8
TF_REF_DEPTH, TF_REF_BUCKETS = 2, ((8, 128, 128), (4, 256, 128))
TF_BEAM, TF_BEAM_BATCH, TF_BEAM_EXTRA = 4, 32, 50
# Transformer-base's cross-attention, timed alone: the target's 128 queries
# against the 256 bucket's sources, [16, N, 8, 64] bf16, ragged keep-mask
TF_CROSS = (16, 128, 256, TF_HEADS, TF_D // TF_HEADS)
# the path's three attention shapes that reach rows 3-5, each held to the
# plain versions: the cross-attention and the two buckets' encoder
# self-attentions
TF_FLASH_SHAPES = (TF_CROSS, (32, 128, 128) + TF_CROSS[3:],
                   (16, 256, 256) + TF_CROSS[3:])
# the f32 check's first gradients, leaf by leaf, each ReLU's gradient on
# float64's side of its kink: kernel path against plain path within
# TF_GRAD_TOL of the leaf's largest float64 gradient and of its norm (the
# key biases, zero in exact arithmetic, over their key weights'), as the
# ResNet and MobileNet holds take RN_GRAD_TOL
TF_GRAD_TOL = 1e-3
# row 6 held at the path's parameter list on the path's gradients and
# moments, at the peak rate of NoamDecay(512, 4000) (step 4000: 512^-0.5 *
# 4000^-0.5), so that the update is far above ADAM_ATOL
TF_ADAM_HOLD_LR = TF_D ** -0.5 * TF_WARMUP ** -0.5
PLAIN_FLAGS = dict(flash_attention="never", flash_backward="never",
                   fused_adam="never", fused_layer_norm="never")


def s2s_flops(batch, ns, nt, d=TF_D, f=TF_FFN, v=TF_VOCAB, enc=TF_LAYERS,
              dec=TF_LAYERS):
    """One training step's matrix-product FLOPs on a padded bucket: three
    times the forward's (the backward is twice the forward): per encoder
    layer the four projections and the feed-forward on every source token
    and QK^T, PV over the source; per decoder layer the self-attention's
    and the cross-attention's query and output projections and the
    feed-forward on every target token, the cross-attention's key and
    value projections on every source token, and both attentions; the
    output projection onto the vocabulary."""
    src, tgt = batch * ns, batch * nt
    fwd = enc * (src * (8 * d * d + 4 * d * f) + 4 * batch * ns * ns * d)
    fwd += dec * (tgt * (12 * d * d + 4 * d * f) + src * 4 * d * d +
                  4 * batch * nt * nt * d + 4 * batch * nt * ns * d)
    return 3 * (fwd + tgt * 2 * d * v)


def flash_cross_case(dev, n_sets=4, seed=SEED + 96, shape=TF_CROSS):
    """``n_sets`` (q, k, v, dout) sets at the cross-attention shape, bf16,
    and a ragged keep-mask over the sources (lengths in (128, 256])."""
    b, nq, nk, h, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    sets = []
    for _ in range(n_sets):
        q, do = (torch.randn(b, nq, h, d, device=dev, generator=g).to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(b, nk, h, d, device=dev, generator=g).to(
            torch.bfloat16) for _ in range(2))
        sets.append((q, k, v, do))
    lens = np.random.default_rng(seed).integers(nk // 2 + 1, nk + 1, b)
    keep = torch.from_numpy(np.arange(nk)[None, :] < lens[:, None]).to(dev)
    return sets, keep


def flash_cross_bounds(q, k, keep):
    """The three kernels' bounds where the queries and the keys differ in
    length: each input read once and each output written once (q, dout,
    o, dq ``[B, Nq, H, D]``; k, v, dk, dv ``[B, Nk, H, D]``; an f32 LSE
    and delta a query row), and the work the kept (query, key) pairs
    need: 4 D flops a pair forward, 8 D for dK/dV, 6 D for dQ."""
    b, nq, h, d = q.shape
    el = q.element_size()
    tq, tk = q.numel() * el, k.numel() * el
    rows = b * h * nq * 4
    pairs = float(keep.sum().item()) * nq * h
    mask_b = keep.numel()
    return {
        "fwd": bound(2 * tq + 2 * tk + rows + mask_b, 4.0 * d * pairs,
                     BF16_FLOPS_PER_S),
        "dkv": bound(2 * tq + 4 * tk + 2 * rows + mask_b, 8.0 * d * pairs,
                     BF16_FLOPS_PER_S),
        "dq": bound(3 * tq + 2 * tk + 2 * rows + mask_b, 6.0 * d * pairs,
                    BF16_FLOPS_PER_S)}


def flash_hold(dev, shape):
    """Rows 3-5 at one attention shape of the path (``[B, Nq, Nk, H, D]``,
    bf16, a ragged keep-mask) held to their plain versions: outputs within
    one bf16 rounding step beyond FLASH_BF16_ABS, the LSE within
    FLASH_TOL, a repeat bit for bit. Returns each kernel's case."""
    from paddle1_tpu_torch.ops import flash_attention as fa
    from paddle1_tpu_torch.ops import flash_attention_bwd as fb
    sets, keep = flash_cross_case(dev, 1, shape=shape)
    scale = 1.0 / shape[-1] ** 0.5
    q, k, v, do = sets[0]
    out, lse = fa.flash_fwd(q, k, v, scale, False, keep)
    ro, rl = fa.flash_attention_ref(q, k, v, scale, False, keep)
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, False, keep)
    dq = fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, False, keep)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, ro, rl, do, scale, False, keep)
    again = (*fa.flash_fwd(q, k, v, scale, False, keep),
             *fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, False, keep),
             fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, False, keep))
    where = f"[{list(q.shape)}, {list(k.shape)}]"
    check(all(torch.equal(a, b) for a, b in zip(again, (out, lse, dk, dv,
                                                       dq))),
          f"flash at {where}: a repeat is not bit-identical")
    lse_err = float((lse - rl).abs().max())
    check(lse_err <= FLASH_TOL, f"flash fwd at {where}: LSE err {lse_err}")
    errs = {}
    for name, ps in (("fwd", [(out, ro)]), ("dkv", [(dk, rk), (dv, rv)]),
                     ("dq", [(dq, rq)])):
        exc = max(bf16_excess(a, b) for a, b in ps)
        check(exc <= FLASH_BF16_ABS, f"flash {name} at {where} exceeds one "
              f"bf16 rounding step by {exc}")
        errs[name] = {"dtype": "torch.bfloat16", "causal": False,
                      "shape": [list(q.shape), list(k.shape)],
                      "max_abs_err": max(float((a.float() - b.float())
                                               .abs().max()) for a, b in ps)}
    return errs


def flash_cross_phase(dev):
    """Rows 3-5 held to their plain versions at the path's three attention
    shapes (TF_FLASH_SHAPES, :func:`flash_hold`), then timed at the
    cross-attention shape (TF_CROSS) by graph replay over four input sets
    beside their plain versions, ``sdpa``'s forward and its backward alone
    (forward + backward less forward) and their bounds."""
    from paddle1_tpu_torch.ops import flash_attention as fa
    from paddle1_tpu_torch.ops import flash_attention_bwd as fb
    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs = {"fwd": [], "dkv": [], "dq": []}
    for shape in TF_FLASH_SHAPES:
        for name, case in flash_hold(dev, shape).items():
            errs[name].append(case)
    sets, keep = flash_cross_case(dev)
    scale = 1.0 / TF_CROSS[-1] ** 0.5
    q, k = sets[0][:2]
    fwd = [fa.flash_fwd(s[0], s[1], s[2], scale, False, keep) for s in sets]
    deltas = [(s[3].float() * f[0].float()).sum(-1).transpose(1, 2)
              .contiguous() for s, f in zip(sets, fwd)]
    t = {"fwd": graph_time_ms([lambda s=s: fa.flash_fwd(
        s[0], s[1], s[2], scale, False, keep) for s in sets]),
        "fwd_plain": graph_time_ms([lambda s=s: fa.flash_attention_ref(
            s[0], s[1], s[2], scale, False, keep) for s in sets]),
        "dkv": graph_time_ms([lambda s=s, f=f, dl=dl: fb.flash_bwd_dkv(
            s[0], s[1], s[2], s[3], f[1], dl, scale, False, keep)
            for s, f, dl in zip(sets, fwd, deltas)]),
        "dq": graph_time_ms([lambda s=s, f=f, dl=dl: fb.flash_bwd_dq(
            s[0], s[1], s[2], s[3], f[1], dl, scale, False, keep)
            for s, f, dl in zip(sets, fwd, deltas)]),
        "bwd_plain": graph_time_ms([lambda s=s, f=f: fa.flash_bwd_ref(
            s[0], s[1], s[2], f[0], f[1], s[3], scale, False, keep)
            for s, f in zip(sets, fwd)])}
    lib = [[x.transpose(1, 2).contiguous() for x in s] for s in sets]
    m4 = keep[:, None, None, :]
    t["fwd_library"] = graph_time_ms([lambda s=s: sdpa(
        s[0], s[1], s[2], attn_mask=m4) for s in lib])
    leaves = [[x.clone().requires_grad_() for x in s[:3]] for s in lib]

    def lib_fwd_bwd(i):
        q_, k_, v_ = leaves[i]
        torch.autograd.grad(sdpa(q_, k_, v_, attn_mask=m4), (q_, k_, v_),
                            lib[i][3])
    t["fwd_bwd_library"] = graph_time_ms([lambda i=i: lib_fwd_bwd(i)
                                          for i in range(len(lib))])
    t["bwd_library"] = t["fwd_bwd_library"] - t["fwd_library"]
    bounds = flash_cross_bounds(q, k, keep)
    out = {"shape": [list(q.shape), list(k.shape), "bf16",
                     "ragged keep-mask"], "times_ms": t,
           "bounds_ms": {n: b[0] for n, b in bounds.items()},
           "bound_by": {n: b[1] for n, b in bounds.items()}, "errors": errs}
    log(json.dumps({"flash_cross_attention": out}))
    return out


def transformer_phase(dev):
    """Phase 30 (the module docstring): eager Transformer-base training
    under ``amp.auto_cast()`` on the two token buckets."""
    import os
    import tempfile
    import paddle1_tpu_torch as paddle
    t0 = time.perf_counter()
    paddle.seed(SEED + 90)
    with paddle.utils.unique_name.guard():
        model = s2s_model(paddle)
    tr = model.transformer
    check(len(tr.encoder.layers) == TF_LAYERS and
          len(tr.decoder.layers) == TF_LAYERS and
          tr.encoder.layers[0].self_attn.num_heads == TF_HEADS and
          tr.decoder.layers[0].linear1.weight.shape == [TF_D, TF_FFN] and
          not tr.encoder.layers[0].normalize_before and
          tr.encoder.norm is None and tr.decoder.norm is None,
          "the model is not Transformer-base (post-norm, 6 + 6 x 512, 8 "
          "heads, feed-forward 2048)")
    check(all(p.device.type == "cuda" and p.dtype == torch.float32
              for p in model.parameters()), "the model is not f32 on the "
          "card")
    n_params = sum(p.nelement() for p in model.parameters())
    rng = np.random.default_rng(SEED + 91)
    batches = [s2s_batch(paddle, model, rng, *b) for b in TF_BUCKETS]
    src_lens = [int((b["src"] != TF_PAD).sum(1).max()) for b in batches]
    tgt_lens = [int((b["tgt_in"] != TF_PAD).sum(1).max()) for b in batches]
    check(src_lens[1] > 128 and tgt_lens[1] <= 128,
          f"the 256 bucket's longest source {src_lens[1]} must pass 128 "
          f"and its longest target {tgt_lens[1]} must not")
    opt, sched = s2s_optimizer(paddle, model)
    step = s2s_step_fn(paddle, model, opt, sched, batches)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eval0 = s2s_eval_loss(paddle, model, batches)
    torch.cuda.reset_peak_memory_stats()
    loss0 = float(step())
    step()
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    slopes, last, steps = timed_steps(step, TF_STEPS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    loss_end = float(last)
    eval_end = s2s_eval_loss(paddle, model, batches)
    check(np.isfinite(loss0) and np.isfinite(loss_end),
          f"transformer: non-finite loss {loss0} / {loss_end}")
    check(eval_end < eval0, f"transformer: the loss over the batches did "
          f"not fall: {eval0} -> {eval_end} (training {loss0} -> "
          f"{loss_end})")
    want = {"flash_attention": 2 * TF_LAYERS * steps,
            "flash_attention_bwd_dkv": 2 * TF_LAYERS * steps,
            "flash_attention_bwd_dq": 2 * TF_LAYERS * steps,
            "fused_adam": steps, "layer_norm": 5 * TF_LAYERS * steps}
    for k, n in want.items():
        check(launches[k] == n, f"transformer: {k} launched {launches[k]} "
              f"times in {steps} steps, want {n}")
    peak = torch.cuda.max_memory_allocated()
    dt = float(np.median(slopes))
    tokens = float(np.mean([b["tokens"] for b in batches]))
    flops = float(np.mean([s2s_flops(*b) for b in TF_BUCKETS]))
    prof = device_kernels_per_step(step, 2)
    busy = prof["device_busy_ms_per_step"]

    # a save -> load into a fresh model and optimizer resumes bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "transformer.pdckpt")
        paddle.save({"model": model.state_dict(), "opt": opt.state_dict()},
                    path)
        ck = paddle.load(path)
    with paddle.utils.unique_name.guard():
        fresh = s2s_model(paddle)
    fmissing, funexpected = fresh.set_state_dict(ck["model"])
    fopt, fsched = s2s_optimizer(paddle, fresh)
    fopt.set_state_dict(ck["opt"])
    del ck
    check(fmissing == [] and funexpected == [] and
          fsched.last_epoch == sched.last_epoch,
          f"transformer resume: missing {fmissing}, unexpected "
          f"{funexpected}, schedule at {fsched.last_epoch} vs "
          f"{sched.last_epoch}")

    def one_step(m, o, s):
        torch.manual_seed(SEED + 92)
        return float(s2s_step_fn(paddle, m, o, s, batches[:1])())
    on, resumed = one_step(model, opt, sched), one_step(fresh, fopt, fsched)
    resume_equal = on == resumed and all(
        torch.equal(a, b) for a, b in zip(model.parameters(),
                                          fresh.parameters()))
    check(resume_equal, f"transformer: a step after save/load differs from "
          f"the uninterrupted run: {on} vs {resumed}")
    del fresh, fopt
    adam_err = transformer_adam_hold(paddle, model, opt, batches[1])
    summary = {
        "train": "transformer_base_eager_amp", "amp": "O1 bfloat16",
        "params": n_params, "buckets": [list(b) for b in TF_BUCKETS],
        "longest_source": src_lens, "longest_target": tgt_lens,
        "real_target_tokens": [b["tokens"] for b in batches],
        "init_s": init_s, "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3,
        "target_tokens_per_s": tokens / dt,
        "flops_per_step": flops, "mfu": flops / dt / BF16_FLOPS_PER_S,
        "mfu_peak": "bf16 989 TFLOP/s",
        "lr_last": sched(), "loss_first": loss0, "loss_last": loss_end,
        "eval_loss_before": eval0, "eval_loss_after": eval_end,
        "peak_mem_gb": peak / 1e9, "peak_mem_gib": peak / 2 ** 30,
        "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / (dt * 1e3),
        "kernels_per_step": prof["kernels_per_step"],
        "resume_loss": [on, resumed], "resume_bit_identical": resume_equal,
        "adam_hold_max_abs_err": adam_err, "profile": prof}
    log(f"transformer-base: {dt * 1e3:.2f} ms a step, "
        f"{tokens / dt:.0f} target tokens/s, MFU {flops / dt / 989e12:.4f}, "
        f"idle {summary['device_idle_share']:.3f} ({card_line()})")
    log(json.dumps({"transformer_base": summary}))
    return model, summary


def tf_first_grads(paddle, m, bs, vocab=TF_VOCAB):
    """The gradients of ``m``'s losses on the batches ``bs``, summed (no
    dropout, no ``auto_cast``): ``(losses, {name: gradient})``; the
    gradients are then cleared."""
    losses = []
    for b in bs:
        loss = s2s_loss(paddle, m(b["src"], b["tgt_in"], b["src_mask"],
                                  b["tgt_mask"]), b["tgt_out"], vocab)
        loss.backward()
        losses.append(float(loss))
    missing = [n for n, p in m.named_parameters() if p.grad is None]
    check(not missing, f"no gradient for {missing}")
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    for p in m.parameters():
        p.grad = None
    return losses, grads


def tf_grad_readings(paddle, model, bs):
    """The first gradients (:func:`tf_first_grads`) of copies of ``model``
    (f32): on the kernel path, on the plain path twice and in float64 (the
    plain path on a float64 copy), then on the kernel path and the plain
    path again with every ReLU's gradient taken on float64's side of its
    kink (the layers' activation as ``nn.ReLU`` under :class:`ActPieces`;
    ``*_same_piece``, with ``flips``: the elements each path's own forward
    puts on the other side). For each pair, per leaf ``max|g_a - g_b| /
    max|g_f64|`` (``max``) and ``|g_a - g_b| / |g_f64|`` (``norm``; the key
    biases, zero in exact arithmetic, over their key weights' g_f64), the
    worst leaf and the median."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    tr = model.transformer
    for layer in (*tr.encoder.layers, *tr.decoder.layers):
        layer.activation = paddle.nn.ReLU()
    acts = ActPieces(model)

    def run(flags, f64=False):
        with flags_guard(**flags):
            m = copy.deepcopy(model)
            if f64:
                m = m.double()
                m.pos = m.pos.double()
            acts.restart()
            return tf_first_grads(paddle, m, bs)
    try:
        runs = {"kernel": run({}), "plain": run(PLAIN_FLAGS),
                "plain_again": run(PLAIN_FLAGS)}
        acts.mode = "record"
        runs["f64"] = run(PLAIN_FLAGS, True)
        acts.mode, flips = "replay", {}
        for k, flags in (("kernel", {}), ("plain", PLAIN_FLAGS)):
            runs[f"{k}_same_piece"] = run(flags)
            flips[k] = acts.take()
    finally:
        acts.remove()
    ref = runs["f64"][1]

    def denom(n, norm):
        g = ref[n[:-len("bias")] + "weight"] if n.endswith("k_proj.bias") \
            else ref[n]
        return float(g.norm() if norm else g.abs().max())
    gaps = {}
    for a, b in (("kernel", "plain"), ("kernel", "f64"), ("plain", "f64"),
                 ("plain", "plain_again"),
                 ("kernel_same_piece", "plain_same_piece"),
                 ("kernel_same_piece", "f64"), ("plain_same_piece", "f64")):
        ga, gb = runs[a][1], runs[b][1]
        for metric, norm in (("max", False), ("norm", True)):
            rel = {}
            for n in ref:
                d = ga[n].double() - gb[n].double()
                rel[n] = float(d.norm() if norm else d.abs().max()) / \
                    denom(n, norm)
            worst = max(rel, key=rel.get)
            gaps[f"{a}_vs_{b}_{metric}"] = {
                "max": rel[worst], "param": worst,
                "median": float(np.median(list(rel.values())))}
    return {"losses": {k: v[0] for k, v in runs.items()}, "gaps": gaps,
            "flips": flips}


def transformer_reference_check(dev):
    """Phase 30's f32 check (TF32 off): Transformer-base's width at depth
    TF_REF_DEPTH + TF_REF_DEPTH, dropout 0, on the TF_REF_BUCKETS, the
    kernel path against the plain path (every kernel flag ``never``) from
    the same seeded weights. First the gradients of both buckets' losses
    (summed), leaf by leaf (:func:`tf_grad_readings`): with every ReLU's
    gradient on float64's side of its kink, the two paths within
    TF_GRAD_TOL of the leaf's largest float64 gradient (rows 3-5 reach
    every attention projection's gradient; the key biases, zero in exact
    arithmetic, are held against their key weights'), by the largest
    element and by the norm. Then REF_STEPS Adam + Noam steps: losses and
    parameters within REF_TOL, the key biases (moved by Adam on rounding
    noise) within the steps' summed rates. The rates are the warm-up's
    first (at most 5.3e-7), so the steps hold the path's sequence end to
    end, not the update; row 6's update is held in
    :func:`transformer_adam_hold`."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.core.flags import flags_guard

    def make():
        paddle.seed(SEED + 93)
        with paddle.utils.unique_name.guard():
            return s2s_model(paddle, enc_layers=TF_REF_DEPTH,
                             dec_layers=TF_REF_DEPTH, dropout=0.0)
    counters = train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    rng = np.random.default_rng(SEED + 94)
    m = make()
    bs = [s2s_batch(paddle, m, rng, *b) for b in TF_REF_BUCKETS]
    grads = tf_grad_readings(paddle, m, bs)
    runs = {}
    for path, flags in (("kernel", {}), ("plain", PLAIN_FLAGS)):
        with flags_guard(**flags):
            m = make()
            opt, sched = s2s_optimizer(paddle, m)
            step = s2s_step_fn(paddle, m, opt, sched, bs, amp=False)
            mark = {k: fn.launches for k, fn in counters.items()}
            lrs, losses = [], []
            for _ in range(REF_STEPS):
                lrs.append(sched())
                losses.append(float(step()))
            torch.cuda.synchronize()
            runs[path] = (m, losses, {k: fn.launches - mark[k]
                                      for k, fn in counters.items()}, lrs)
    (mk, lk, nk, lrs), (mp, lp, np_, _) = runs["kernel"], runs["plain"]
    for k in counters:
        counters[k].launches = before[k]
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
    out = {"transformer_reference": {
        "depth": [TF_REF_DEPTH, TF_REF_DEPTH], "dtype": "float32",
        "tf32": False, "buckets": [list(b) for b in TF_REF_BUCKETS],
        "grads": grads, "grad_tol": TF_GRAD_TOL,
        "steps": REF_STEPS, "lrs": lrs, "losses_kernel": lk,
        "losses_plain": lp, "max_loss_err": loss_err,
        "max_param_err": param_err, "max_key_bias_err": key_bias_err,
        "kernel_launches": nk}}
    log(json.dumps(out))
    for metric in ("max", "norm"):
        gap = grads["gaps"][f"kernel_same_piece_vs_plain_same_piece_{metric}"]
        check(gap["max"] <= TF_GRAD_TOL, f"transformer reference: the "
              f"first gradients of {gap['param']} differ by {gap['max']} "
              f"of float64's ({metric})")
    check(loss_err <= REF_TOL, f"transformer reference: losses differ by "
          f"{loss_err}: {lk} vs {lp}")
    check(param_err <= REF_TOL, f"transformer reference: params differ by "
          f"{param_err}")
    check(key_bias_err <= sum(lrs), f"transformer reference: key biases "
          f"differ by {key_bias_err} > {sum(lrs)}")
    del runs, mk, mp
    torch.cuda.empty_cache()
    return out


def transformer_adam_hold(paddle, model, opt, batch):
    """Row 6 at the path's shapes: Transformer-base's whole parameter list
    (copies of the parameters and of the optimizer's moments after phase
    30's steps, and the gradients of one more step's loss on ``batch``),
    one kernel launch against the plain version per tensor
    (:func:`adam_check`), with the path's betas and epsilon at the
    schedule's peak rate TF_ADAM_HOLD_LR and bias corrections of the
    optimizer's next step. Returns the max abs error."""
    from paddle1_tpu_torch.ops import fused_adam as fad
    with paddle.amp.auto_cast():
        s2s_loss(paddle, model(batch["src"], batch["tgt_in"],
                               batch["src_mask"], batch["tgt_mask"]),
                 batch["tgt_out"]).backward()
    # the moments in the parameters' order (names repeat across the
    # layers' copies; the state's keys tell the repeats apart)
    state, params = opt.state_dict(), list(model.parameters())
    m1, m2 = ([v for k, v in state.items() if k.endswith(f"__{slot}")]
              for slot in ("moment1", "moment2"))
    check(len(m1) == len(m2) == len(params), f"Adam's state holds "
          f"{len(m1)} / {len(m2)} moments for {len(params)} parameters")
    ts = ([p.detach().clone() for p in params],
          [p.grad.detach().clone() for p in params], m1, m2)
    opt.clear_grad()
    t = state["step"] + 1
    sc = torch.tensor([TF_ADAM_HOLD_LR, 1 - TF_BETA1 ** t, 1 - TF_BETA2 ** t],
                      device=params[0].device)
    err = adam_check(fad, ts, sc, [0.0] * len(params), None,
                     f"Transformer-base ({len(params)} tensors)",
                     (TF_BETA1, TF_BETA2, TF_EPS))
    del ts, state
    return err


def traced_beam_decoder(paddle, trace):
    """``nn.BeamSearchDecoder`` that appends to the list ``trace`` each
    step's best 2 x beam candidates as the decoder ranked them (its
    ``candidates``: scores and flat indices over ``beam x vocab``,
    ``[B, 2 * beam]`` each)."""
    class Traced(paddle.nn.BeamSearchDecoder):
        def _beam_search_step(self, *args):
            out = super()._beam_search_step(*args)
            trace.append(tuple(t.clone() for t in self.candidates))
            return out
    return Traced


def beam_divergence(tk, tp, beam, vocab=TF_VOCAB):
    """Where two traces of one batch's beam search
    (:func:`traced_beam_decoder`; the kernel path's ``tk``, the plain
    path's ``tp``) first choose differently: the first step and sentence
    whose best ``beam`` candidates differ, the first rank there whose
    candidate differs, the kernel path's candidate and the plain path's
    (``[parent, token]``), each path's score gap between its own choice
    and the other's (None where the other's lies outside its best 2 x
    beam), and how far the paths' beam scores lay apart at the steps
    before. None where every step both made chose alike."""
    for t_, ((sk, ik), (sp, ip)) in enumerate(zip(tk, tp)):
        rows = torch.nonzero((ik[:, :beam] != ip[:, :beam]).any(-1))
        if len(rows):
            break
    else:
        return None
    b_ = int(rows[0, 0])
    sk, ik, sp, ip = sk[b_], ik[b_], sp[b_], ip[b_]
    j = int(torch.nonzero(ik[:beam] != ip[:beam])[0, 0])
    a, c = int(ik[j]), int(ip[j])

    def gap(s, i, other):
        at = torch.nonzero(i == other)
        return float(s[j] - s[int(at[0, 0])]) if len(at) else None
    before = max((float((x[0][:, :beam] - y[0][:, :beam]).abs().max())
                  for x, y in zip(tk[:t_], tp[:t_])), default=0.0)
    return {"step": t_, "sentence": b_, "rank": j,
            "kernel_choice": list(divmod(a, vocab)),
            "plain_choice": list(divmod(c, vocab)),
            "gap_kernel": gap(sk, ik, c), "gap_plain": gap(sp, ip, a),
            "score_err_before": before}


def transformer_decode_phase(dev, model):
    """Phase 31 (the module docstring): beam search with phase 30's
    weights in f32, with the end token (the model's own lengths), and with
    an end token past the vocabulary, so that every sentence runs to the
    length limit."""
    import paddle1_tpu_torch as paddle
    rng = np.random.default_rng(SEED + 95)
    b = s2s_batch(paddle, model, rng, TF_BEAM_BATCH, 128, 128)
    src_len = int((b["src"] != TF_PAD).sum(1).max())
    max_step = src_len + TF_BEAM_EXTRA
    s2s_decode(paddle, model, b["src"], b["src_mask"], TF_BEAM,
               max_step_num=2)   # warm-up
    out = {"decode": "transformer_base_beam_search", "dtype": "float32",
           "beam": TF_BEAM, "sentences": TF_BEAM_BATCH,
           "longest_source": src_len, "max_step_num": max_step}
    for tag, end in (("end_token", TF_EOS), ("length_limit", TF_VOCAB)):
        out[tag] = beam_search_run(paddle, model, b, max_step, end)
        r = out[tag]
        log(f"beam search ({tag}): {r['ms_per_step']:.3f} ms a step over "
            f"{r['steps']} steps, {r['sentences_per_s']:.2f} sentences/s, "
            f"idle {r['device_idle_share']:.3f} ({card_line()})")
    check(out["length_limit"]["steps"] == max_step + 1,
          f"beam search at the length limit made "
          f"{out['length_limit']['steps']} steps, want {max_step + 1}")
    log(json.dumps({"transformer_beam_search": out}))
    return out


def beam_search_run(paddle, model, b, max_step, end):
    """One beam search over batch ``b``: timed with the counters zeroed
    just before and read just after (row 3 on the encoder, row 2 on every
    LayerNorm), profiled once, then traced on the kernel path and the
    plain path, whose ids must be equal, or part only at a near tie
    (:func:`beam_divergence`)."""
    from paddle1_tpu_torch.core.flags import flags_guard
    src, mask = b["src"], b["src_mask"]
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = s2s_decode(paddle, model, src, mask, TF_BEAM, max_step_num=max_step,
                     end_token=end)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_steps = int(ids.shape[1])
    check(list(ids.shape) == [TF_BEAM_BATCH, n_steps, TF_BEAM] and
          1 <= n_steps <= max_step + 1, f"beam search: ids of shape "
          f"{list(ids.shape)}")
    want = {"flash_attention": TF_LAYERS, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0, "fused_adam": 0,
            "layer_norm": 2 * TF_LAYERS + 3 * TF_LAYERS * n_steps}
    for k, n in want.items():
        check(launches[k] == n, f"beam search: {k} launched {launches[k]} "
              f"times over {n_steps} steps, want {n}")
    prof = device_kernels_per_step(
        lambda: s2s_decode(paddle, model, src, mask, TF_BEAM,
                           max_step_num=max_step, end_token=end).sum(), 1)
    busy = prof["device_busy_ms_per_step"]
    ids_by_path, traces = {}, {}
    for path, flags in (("kernel", {}), ("plain", PLAIN_FLAGS)):
        with flags_guard(**flags):
            traces[path] = []
            ids_by_path[path] = s2s_decode(
                paddle, model, src, mask, TF_BEAM, max_step_num=max_step,
                beam_decoder=traced_beam_decoder(paddle, traces[path]),
                end_token=end)
    ik, ip = ids_by_path["kernel"], ids_by_path["plain"]
    equal = ik.shape == ip.shape and torch.equal(ik, ip)
    divergence = beam_divergence(traces["kernel"], traces["plain"], TF_BEAM)
    check(equal or divergence is not None, "beam search: the paths' ids "
          "differ but their steps chose alike")
    if divergence is not None:
        d = divergence
        gaps = (d["gap_kernel"], d["gap_plain"])
        log(f"beam search: the kernel and plain paths part at step "
            f"{d['step']} of sentence {d['sentence']}, rank {d['rank']}: "
            f"{d['kernel_choice']} against {d['plain_choice']} ([parent, "
            f"token]), {gaps[0]} apart on the kernel path, {gaps[1]} on "
            f"the plain path (the paths' scores {d['score_err_before']:.3e} "
            f"apart before it)")
        check(None not in gaps and max(gaps) <= LOGIT_TOL and
              d["score_err_before"] <= LOGIT_TOL,
              f"beam search: the paths part where the swapped candidates "
              f"are not a near tie within {LOGIT_TOL}: {d}")
    return {"end_token": end, "steps": n_steps, "seconds": dt,
            "ms_per_step": dt * 1e3 / n_steps,
            "sentences_per_s": TF_BEAM_BATCH / dt,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (dt * 1e3),
            "kernels_per_decode": prof["kernels_per_step"],
            "launches": launches,
            "beams_ending": float((ids == end).any(1).float().mean()),
            "ids_equal_to_plain": equal, "divergence": divergence,
            "tolerance": LOGIT_TOL,
            "top_kernels": prof["top_kernels"]}


# ---------------------------------------------------------------------------
# phases 32-33: an attention LSTM encoder-decoder (the twelfth main path)

# Luong et al. 2015's global attention (the "general" score, input feeding)
# at the IWSLT'15 English->Vietnamese widths of PaddleNLP's
# examples/machine_translation/seq2seq: source vocabulary 17191, target
# vocabulary 7709, embedding = hidden = 512, 2 layers, dropout 0.2, the
# embeddings and projections uniform in +-0.1 (--init_scale 0.1; the LSTMs
# keep their own +-1/sqrt(512)), Adam(1e-3) with a global-norm clip at 5.0,
# batch 128, training sentences of at most 50 tokens. Ids as the
# example's: 0 begins a sentence, 1 ends it and pads it.
LS_SRC_VOCAB, LS_TGT_VOCAB, LS_D, LS_LAYERS = 17191, 7709, 512, 2
LS_DROPOUT, LS_INIT, LS_LR, LS_CLIP = 0.2, 0.1, 1e-3, 5.0
LS_BOS, LS_EOS = 0, 1
LS_BATCH, LS_MIN_LEN, LS_MAX_LEN = 128, 5, 50
LS_PARAMS = 26935808
LS_STEPS = 8
# the f32 check's batch (full width and depth, dropout 0)
LS_REF_BATCH = 16
# beam search: the example's beam 10 over 32 sources, at most 100 steps
# (twice the training length limit)
LS_BEAM, LS_BEAM_BATCH, LS_BEAM_MAX_STEP = 10, 32, 100
# the seeds of phase 32's two training batches and phase 33's decode batch
LS_TRAIN_SEED, LS_BEAM_SEED = SEED + 161, SEED + 167
LS_PLAIN_FLAGS = dict(PLAIN_FLAGS, fused_softmax="never")


def ls_model(paddle, src_vocab=LS_SRC_VOCAB, tgt_vocab=LS_TGT_VOCAB,
             d=LS_D, layers=LS_LAYERS, dropout=LS_DROPOUT,
             init_scale=LS_INIT):
    """The translation model of the user script: ``nn.Embedding(src_vocab,
    d)`` into ``nn.LSTM(d, d, layers, dropout=dropout)``; the decoder
    ``nn.Embedding(tgt_vocab, d)`` into ``nn.RNN`` over an attention cell
    (``layers`` ``nn.LSTMCell``s, the first fed the target embedding and
    the previous attentional state, dropout on each cell's output; Luong's
    "general" score ``h W_a e_s`` over the encoder's outputs, the padded
    sources at -1e9, ``F.softmax`` (row 7), the context ``p @ e``, the
    attentional state ``tanh(W_c [ctx; h])``), then ``Linear(d,
    tgt_vocab)`` without bias. ``nn.RNN`` passes the cell no keyword
    arguments, so :meth:`forward` sets the encoder's outputs on the cell
    (``cell.memory``) for the call; beam search passes them through
    ``dynamic_decode(..., memory=...)``."""
    nn, F = paddle.nn, paddle.nn.functional

    def uniform():
        return paddle.ParamAttr(initializer=nn.initializer.Uniform(
            -init_scale, init_scale))

    class AttentionCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = d
            self.lstm = nn.LayerList([nn.LSTMCell(2 * d if i == 0 else d, d)
                                      for i in range(layers)])
            self.dropout = nn.Dropout(dropout)
            self.w_a = nn.Linear(d, d, weight_attr=uniform(),
                                 bias_attr=False)
            self.w_c = nn.Linear(2 * d, d, weight_attr=uniform(),
                                 bias_attr=False)
            self.memory = None

        def forward(self, step_input, states, memory=None):
            values, keys, bias = memory if memory is not None else \
                self.memory
            lstm_states, feed = states
            x = paddle.concat([step_input, feed], 1)
            new_states = []
            for cell, st in zip(self.lstm, lstm_states):
                h, st = cell(x, st)
                x = self.dropout(h)
                new_states.append(st)
            scores = paddle.matmul(paddle.unsqueeze(x, [1]), keys,
                                   transpose_y=True)
            p = F.softmax(scores + bias)
            ctx = paddle.squeeze(paddle.matmul(p, values), [1])
            out = paddle.tanh(self.w_c(paddle.concat([ctx, x], 1)))
            return out, [new_states, out]

    class Seq2SeqAttn(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedding = nn.Embedding(src_vocab, d,
                                              weight_attr=uniform())
            self.encoder = nn.LSTM(d, d, layers, dropout=dropout)
            self.tgt_embedding = nn.Embedding(tgt_vocab, d,
                                              weight_attr=uniform())
            self.decoder = nn.RNN(AttentionCell())
            self.output = nn.Linear(d, tgt_vocab, weight_attr=uniform(),
                                    bias_attr=False)

        def encode(self, src):
            """The encoder's outputs, ``W_a`` of them and the pads' -1e9
            ``[B, 1, S]`` (the cell's ``memory``), and the decoder's
            initial states: each layer's final ``(h, c)`` and a zero
            attentional state."""
            values, (h, c) = self.encoder(self.src_embedding(src))
            keep = (src != LS_EOS).astype("float32")
            bias = paddle.unsqueeze((keep - 1.0) * 1e9, [1])
            cell = self.decoder.cell
            states = [[(h[i], c[i]) for i in range(layers)],
                      cell.get_initial_states(values)]
            return (values, cell.w_a(values), bias), states

        def forward(self, src, tgt_in):
            memory, states = self.encode(src)
            self.decoder.cell.memory = memory
            try:
                h, _ = self.decoder(self.tgt_embedding(tgt_in), states)
            finally:
                self.decoder.cell.memory = None
            return self.output(h)

    return Seq2SeqAttn()


def ls_batch_arrays(rng, batch, src_vocab=LS_SRC_VOCAB,
                    tgt_vocab=LS_TGT_VOCAB, min_len=LS_MIN_LEN,
                    max_len=LS_MAX_LEN):
    """One seeded batch as numpy arrays: sources of ragged length in
    [min_len, max_len], padded with the end id to the batch's longest;
    each target a fixed token map of its source (a synthetic translation a
    model can learn), fed as [begin, y] and scored as [y, end], padded with
    the end id. ``sequence_length`` is not passed: both packages' LSTMs
    ignore it, so the encoder runs over the pads and the attention's -1e9
    hides them; the loss masks the target's pads by
    ``F.sequence_mask``."""
    lens = rng.integers(min_len, max_len + 1, batch)
    s = int(lens.max())
    src = rng.integers(2, src_vocab, (batch, s))
    src[np.arange(s)[None, :] >= lens[:, None]] = LS_EOS
    y = (src * 7 + 11) % (tgt_vocab - 2) + 2
    tgt_in = np.full((batch, s + 1), LS_EOS, np.int64)
    label = np.full((batch, s + 1), LS_EOS, np.int64)
    for i, n in enumerate(lens):
        tgt_in[i, 0], tgt_in[i, 1:n + 1] = LS_BOS, y[i, :n]
        label[i, :n] = y[i, :n]
    return {"src": src.astype(np.int64), "tgt_in": tgt_in,
            "label": label[..., None], "tgt_len": (lens + 1).astype(np.int64),
            "tokens": int((lens + 1).sum()), "src_steps": s,
            "tgt_steps": s + 1}


def ls_tensors(paddle, arrays):
    """A batch of :func:`ls_batch_arrays` as Paddle tensors on the current
    place."""
    return {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()}


def ls_batch(paddle, rng, batch, *sizes):
    """One seeded batch (:func:`ls_batch_arrays`) as Paddle tensors."""
    return ls_tensors(paddle, ls_batch_arrays(rng, batch, *sizes))


def ls_path_arrays():
    """The batches phases 32-33 run, from their seeds: the two training
    batches of LS_BATCH and the decode batch of LS_BEAM_BATCH."""
    rng = np.random.default_rng(LS_TRAIN_SEED)
    train = [ls_batch_arrays(rng, LS_BATCH) for _ in range(2)]
    beam = ls_batch_arrays(np.random.default_rng(LS_BEAM_SEED), LS_BEAM_BATCH)
    return train, beam


def ls_sm_shapes():
    """Row 7's ``(rows, S)`` on this path, for f32 ``[rows, 1, S]``
    attention scores: each training batch's ``(LS_BATCH, S)`` and the
    decode batch's ``(LS_BEAM_BATCH x LS_BEAM, S)``, S the batch's longest
    source as :func:`ls_path_arrays` builds it, and both row counts at the
    length limit LS_MAX_LEN."""
    train, beam = ls_path_arrays()
    rows = {(LS_BATCH, b["src_steps"]) for b in train}
    rows.add((LS_BEAM_BATCH * LS_BEAM, beam["src_steps"]))
    rows |= {(LS_BATCH, LS_MAX_LEN), (LS_BEAM_BATCH * LS_BEAM, LS_MAX_LEN)}
    return sorted(rows)


def ls_loss(paddle, logits, label, tgt_len):
    """The example's ``CrossEntropyCriterion``: per-token cross entropy,
    the target's pads masked by ``F.sequence_mask``, summed over the steps
    of the batch mean (the real target tokens' loss over the batch)."""
    F = paddle.nn.functional
    ce = paddle.squeeze(F.cross_entropy(logits, label, reduction="none"),
                        [2])
    mask = F.sequence_mask(tgt_len, maxlen=int(label.shape[1]),
                           dtype="float32")
    return paddle.sum(paddle.mean(ce * mask, axis=[0]))


def ls_optimizer(paddle, model, lr=LS_LR):
    """``Adam(lr)`` with ``nn.ClipGradByGlobalNorm(5.0)``."""
    return paddle.optimizer.Adam(
        learning_rate=lr, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(LS_CLIP))


def ls_step_fn(paddle, model, opt, batches):
    """One eager f32 training step over the batches in turn:
    ``loss.backward(); opt.step(); opt.clear_grad()``. ``step.trail``
    lists each step's decoder steps (the batch's padded target length)."""
    trail = []

    def step():
        b = batches[len(trail) % len(batches)]
        trail.append(b["tgt_steps"])
        loss = ls_loss(paddle, model(b["src"], b["tgt_in"]), b["label"],
                       b["tgt_len"])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    step.trail = trail
    return step


def ls_decode(paddle, model, src, beam=LS_BEAM, max_step_num=LS_BEAM_MAX_STEP,
              end_token=LS_EOS, beam_decoder=None):
    """Beam search (``beam`` > 1, ``nn.BeamSearchDecoder`` over the
    attention cell with ``embedding_fn`` the target embedding and
    ``output_fn`` the output projection, the encoder's outputs tiled by
    ``tile_beam_merge_with_batch``) or greedy decoding (``beam`` = 1,
    ``BasicDecoder`` and ``GreedyEmbeddingHelper``) through
    ``nn.dynamic_decode(..., memory=...)`` in eval mode under
    ``no_grad``. Returns the token ids, ``[B, T, beam]`` (the final
    beams, best first) or ``[B, T]``. ``beam_decoder``: the beam-search
    class (``nn.BeamSearchDecoder`` when None)."""
    nn = paddle.nn
    model.eval()
    with paddle.no_grad():
        memory, states = model.encode(src)
        cell = model.decoder.cell
        if beam == 1:
            helper = nn.GreedyEmbeddingHelper(
                model.tgt_embedding,
                paddle.full([int(src.shape[0])], LS_BOS, "int64"), end_token)
            out, _ = nn.dynamic_decode(
                nn.BasicDecoder(cell, helper, model.output), inits=states,
                max_step_num=max_step_num, memory=memory)
            ids = out.sample_ids
        else:
            tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
            dec = (beam_decoder or nn.BeamSearchDecoder)(
                cell, LS_BOS, end_token, beam,
                embedding_fn=model.tgt_embedding, output_fn=model.output)
            ids, _ = nn.dynamic_decode(dec, inits=states,
                                       max_step_num=max_step_num,
                                       memory=tile(memory, beam))
    model.train()
    return ids


def ls_eval_loss(paddle, model, batches):
    """The mean loss over ``batches`` in eval mode (no dropout) under
    ``no_grad``; the model goes back to training mode."""
    model.eval()
    with paddle.no_grad():
        losses = [float(ls_loss(paddle, model(b["src"], b["tgt_in"]),
                                b["label"], b["tgt_len"])) for b in batches]
    model.train()
    return float(np.mean(losses))


def ls_counters():
    """The launch counters the path reads: rows 6 and 7, and the kernels
    it must not launch (flash, LayerNorm)."""
    from paddle1_tpu_torch.ops import softmax as psm
    return {**train_counters(), "softmax": psm.fused_softmax}


def ls_softmax_hold(dev):
    """Row 7 alone at :func:`ls_sm_shapes`, f32 ``[rows, 1, S]`` scores with a
    ragged tail of pads at -1e9 (as the attention adds them): against its
    plain version (SM_TOL), repeats bit-identical, its autograd gradient
    against plain autograd; timed by graph replay beside its plain
    version, ``torch.softmax`` and its bound (x read once, y written once,
    five f32 operations an element)."""
    from paddle1_tpu_torch.ops import softmax as psm
    out = []
    for rows, s in ls_sm_shapes():
        g = torch.Generator(device=dev).manual_seed(SEED + 170 + rows)
        xs = []
        for _ in range(4):
            x = torch.randn(rows, 1, s, device=dev, generator=g) * 4
            lens = torch.randint(LS_MIN_LEN, s + 1, (rows,), device=dev,
                                 generator=g)
            pad = torch.arange(s, device=dev)[None, :] >= lens[:, None]
            xs.append(x - 1e9 * pad[:, None, :].float())
        y = psm.softmax_fwd(xs[0])
        err = float((y - psm.softmax_ref(xs[0])).abs().max())
        tag = f"[{rows}, 1, {s}] f32"
        check(err <= SM_TOL, f"softmax {tag}: err {err} > {SM_TOL}")
        check(torch.equal(psm.softmax_fwd(xs[0]), y),
              f"softmax {tag}: a repeat differs")
        dy = torch.randn(rows, 1, s, device=dev, generator=g)
        xk = xs[1].clone().requires_grad_(True)
        psm.fused_softmax(xk).backward(dy)
        xr = xs[1].clone().requires_grad_(True)
        torch.softmax(xr, dim=-1).backward(dy)
        grad_err = float((xk.grad - xr.grad).abs().max())
        check(grad_err <= SM_TOL, f"softmax {tag}: autograd dx differs by "
              f"{grad_err}")
        t = {"ms": graph_time_ms([lambda x=x: psm.softmax_fwd(x)
                                  for x in xs]),
             "plain_ms": graph_time_ms([lambda x=x: psm.softmax_ref(x)
                                        for x in xs]),
             "library_ms": graph_time_ms([lambda x=x: torch.softmax(x, dim=-1)
                                          for x in xs])}
        need = 2 * rows * s * 4
        b_ms, by = bound(need, 5.0 * rows * s, F32_FLOPS_PER_S)
        out.append({"shape": [rows, 1, s], "dtype": "float32", **t,
                    "max_abs_err": err, "autograd_max_abs_err": grad_err,
                    "path": psm.plan(rows, s, 4).path,
                    "library_covers": "torch.softmax (last axis)",
                    "bound_ms": b_ms, "bound_by": by, "bound_bytes": need,
                    "input_sets": len(xs)})
        log(f"softmax f32 {tag}: err {err:.3e}, kernel {t['ms']:.5f} ms, "
            f"plain {t['plain_ms']:.5f} ms, torch.softmax "
            f"{t['library_ms']:.5f} ms, bound {b_ms:.6f} ms ({by}) "
            f"({card_line()})")
    return out


def ls_adam_hold(paddle, model, opt, batch):
    """Row 6 over the path's whole parameter list (copies of the
    parameters and of Adam's moments after phase 32's steps, and the
    gradients of one more step's loss on ``batch``), one launch against
    the plain version per tensor (:func:`adam_check`) at the path's rate
    and the optimizer's next bias corrections; then timed in five
    alternating rounds of graph replays beside
    ``torch.optim.Adam(fused=True, capturable=True)`` on the same
    tensors, and the plain per-tensor update and its bound."""
    from paddle1_tpu_torch.ops import fused_adam as fad
    ls_loss(paddle, model(batch["src"], batch["tgt_in"]), batch["label"],
            batch["tgt_len"]).backward()
    state, params = opt.state_dict(), list(model.parameters())
    m1, m2 = ([v for k, v in state.items() if k.endswith(f"__{slot}")]
              for slot in ("moment1", "moment2"))
    check(len(m1) == len(m2) == len(params), f"Adam's state holds "
          f"{len(m1)} / {len(m2)} moments for {len(params)} parameters")
    ts = ([p.detach().clone() for p in params],
          [p.grad.detach().clone() for p in params], m1, m2)
    opt.clear_grad()
    t = state["step"] + 1
    sc = torch.tensor([LS_LR, 1 - 0.9 ** t, 1 - 0.999 ** t],
                      device=params[0].device)
    n_el = sum(p.nelement() for p in params)
    err = adam_check(fad, ts, sc, [0.0] * len(params), None,
                     f"LSTM seq2seq ({len(params)} tensors, {n_el} "
                     f"elements)", (0.9, 0.999, 1e-8))
    ps, gs, _, _ = ts
    lib_ps = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    for p, q in zip(lib_ps, gs):
        p.grad = q
    lib_opt = torch.optim.Adam(lib_ps, lr=LS_LR, fused=True,
                               capturable=True)
    decs = [0.0] * len(ps)
    times = alternating_ms({
        "kernel": lambda: fad.fused_adam_(ps, gs, m1, m2, sc, decs, 0.9,
                                          0.999, 1e-8),
        "library": lib_opt.step})

    def plain():
        for p, q, a, b in zip(ps, gs, m1, m2):
            np_, na, nb = fad.fused_adam_ref(p, q, a, b, sc[0], sc[1], sc[2],
                                             0.0, 0.9, 0.999, 1e-8)
            p.copy_(np_)
            a.copy_(na)
            b.copy_(nb)
    plain_ms = graph_time_ms([plain], reps=5)
    b_ms, by = bound(28.0 * n_el, 12.0 * n_el, F32_FLOPS_PER_S)
    out = {"tensors": len(ps), "elements": n_el, "max_abs_err": err,
           "ms": times["kernel"]["median_ms"],
           "ms_spread": times["kernel"]["spread_ms"],
           "library_ms": times["library"]["median_ms"],
           "library_ms_spread": times["library"]["spread_ms"],
           "library": "torch.optim.Adam(fused=True, capturable=True)",
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}
    log(f"fused_adam at the LSTM seq2seq's {len(ps)} tensors ({n_el} "
        f"elements, f32): kernel {out['ms']:.5f} ms, library "
        f"{out['library_ms']:.5f} ms, plain {plain_ms:.5f} ms, bound "
        f"{b_ms:.5f} ms ({by}) ({card_line()})")
    del ts, ps, gs, lib_ps, lib_opt, state
    torch.cuda.empty_cache()
    return out


def lstm_seq2seq_phase(dev):
    """Phase 32 (the module docstring): eager f32 training of the attention
    LSTM seq2seq on two cycled batches of 128."""
    import os
    import tempfile
    import paddle1_tpu_torch as paddle
    t0 = time.perf_counter()
    paddle.seed(SEED + 160)
    with paddle.utils.unique_name.guard():
        model = ls_model(paddle)
    n_params = sum(p.nelement() for p in model.parameters())
    check(n_params == LS_PARAMS, f"the LSTM seq2seq has {n_params} "
          f"parameters, want {LS_PARAMS}")
    check(all(p.device.type == "cuda" and p.dtype == torch.float32
              for p in model.parameters()), "the model is not f32 on the "
          "card")
    batches = [ls_tensors(paddle, a) for a in ls_path_arrays()[0]]
    check(all((LS_BATCH, b["src_steps"]) in ls_sm_shapes() for b in batches),
          "lstm seq2seq: a training batch's row-7 shape is not held alone")
    opt = ls_optimizer(paddle, model)
    step = ls_step_fn(paddle, model, opt, batches)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eval0 = ls_eval_loss(paddle, model, batches)
    torch.cuda.reset_peak_memory_stats()
    loss0 = float(step())
    step()
    counters = ls_counters()
    for fn in counters.values():
        fn.launches = 0
    mark = len(step.trail)
    slopes, last, steps = timed_steps(step, LS_STEPS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    decoder_steps = sum(step.trail[mark:])
    loss_end = float(last)
    eval_end = ls_eval_loss(paddle, model, batches)
    check(np.isfinite(loss0) and np.isfinite(loss_end),
          f"lstm seq2seq: non-finite loss {loss0} / {loss_end}")
    check(eval_end < eval0, f"lstm seq2seq: the loss over the batches did "
          f"not fall: {eval0} -> {eval_end} (training {loss0} -> "
          f"{loss_end})")
    want = {"softmax": decoder_steps, "fused_adam": steps,
            "flash_attention": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0, "layer_norm": 0}
    for k, n in want.items():
        check(launches[k] == n, f"lstm seq2seq: {k} launched {launches[k]} "
              f"times in {steps} steps ({decoder_steps} decoder steps), "
              f"want {n}")
    peak = torch.cuda.max_memory_allocated()
    dt = float(np.median(slopes))
    tokens = float(np.mean([b["tokens"] for b in batches]))
    prof = device_kernels_per_step(step, 2)
    busy = prof["device_busy_ms_per_step"]

    # a save -> load into a fresh model and optimizer resumes bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lstm_seq2seq.pdckpt")
        paddle.save({"model": model.state_dict(), "opt": opt.state_dict()},
                    path)
        ck = paddle.load(path)
    with paddle.utils.unique_name.guard():
        fresh = ls_model(paddle)
    fmissing, funexpected = fresh.set_state_dict(ck["model"])
    fopt = ls_optimizer(paddle, fresh)
    fopt.set_state_dict(ck["opt"])
    del ck
    check(fmissing == [] and funexpected == [], f"lstm seq2seq resume: "
          f"missing {fmissing}, unexpected {funexpected}")

    def one_step(m, o):
        torch.manual_seed(SEED + 162)
        return float(ls_step_fn(paddle, m, o, batches[:1])())
    on, resumed = one_step(model, opt), one_step(fresh, fopt)
    resume_equal = on == resumed and all(
        torch.equal(a, b) for a, b in zip(model.parameters(),
                                          fresh.parameters()))
    check(resume_equal, f"lstm seq2seq: a step after save/load differs "
          f"from the uninterrupted run: {on} vs {resumed}")
    del fresh, fopt
    adam = ls_adam_hold(paddle, model, opt, batches[1])
    summary = {
        "train": "lstm_attention_seq2seq_eager_f32", "tf32": False,
        "params": n_params, "batch": LS_BATCH,
        "source_steps": [b["src_steps"] for b in batches],
        "target_steps": [b["tgt_steps"] for b in batches],
        "real_target_tokens": [b["tokens"] for b in batches],
        "init_s": init_s, "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3,
        "target_tokens_per_s": tokens / dt,
        "loss_first": loss0, "loss_last": loss_end,
        "eval_loss_before": eval0, "eval_loss_after": eval_end,
        "peak_mem_gb": peak / 1e9, "peak_mem_gib": peak / 2 ** 30,
        "launches": launches, "decoder_steps": decoder_steps,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / (dt * 1e3),
        "kernels_per_step": prof["kernels_per_step"],
        "resume_loss": [on, resumed], "resume_bit_identical": resume_equal,
        "adam": adam, "profile": prof}
    log(f"lstm seq2seq: {dt * 1e3:.2f} ms a step, {tokens / dt:.0f} target "
        f"tokens/s, busy {busy:.2f} ms, idle "
        f"{summary['device_idle_share']:.3f}, "
        f"{prof['kernels_per_step']:.0f} kernels a step, peak "
        f"{peak / 1e9:.2f} GB ({card_line()})")
    log(json.dumps({"lstm_seq2seq": summary}))
    return model, summary


def lstm_cell_equivalence(dev):
    """``nn.LSTM`` (one ``_VF.lstm`` call a layer: cuDNN) against two
    ``nn.RNN(nn.LSTMCell)`` layers (one ``_VF.lstm_cell`` a step) over the
    same weights, at the path's encoder shape (f32 ``[128, 50, 512]``, 2
    layers, TF32 off): outputs and final states within 1e-5 (abs and
    rel), the gradients of the input and of every weight within 1e-5 of
    each one's largest element (cuDNN sums a weight's gradient over all
    6400 rows in one product, the cells step by step: the orders differ by
    f32 rounding, 4.0e-5 absolute on a weight gradient whose largest
    element is 46 on an NVIDIA H100 80GB HBM3)."""
    import paddle1_tpu_torch as paddle
    paddle.seed(SEED + 163)
    with paddle.utils.unique_name.guard():
        net = paddle.nn.LSTM(LS_D, LS_D, LS_LAYERS)
        cells = [paddle.nn.RNN(paddle.nn.LSTMCell(LS_D, LS_D))
                 for _ in range(LS_LAYERS)]
    for k, rnn in enumerate(cells):
        rnn.cell.set_state_dict({n: getattr(net, f"{n}_l{k}") for n in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh")})
    g = torch.Generator(device=dev).manual_seed(SEED + 164)
    x = torch.randn(LS_BATCH, LS_MAX_LEN, LS_D, device=dev, generator=g)
    w = torch.randn(LS_BATCH, LS_MAX_LEN, LS_D, device=dev, generator=g)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out_a, (h_a, c_a) = net(xa)
    y, finals = xb, []
    for rnn in cells:
        y, st = rnn(y)
        finals.append(st)
    h_b = torch.stack([s[0] for s in finals])
    c_b = torch.stack([s[1] for s in finals])
    ((out_a * w).sum() + h_a.sum() + c_a.sum()).backward()
    ((y * w).sum() + h_b.sum() + c_b.sum()).backward()
    pairs = [("output", out_a, y), ("h", h_a, h_b), ("c", c_a, c_b),
             ("grad x", xa.grad, xb.grad)]
    for k, rnn in enumerate(cells):
        for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            pairs.append((f"grad {n}_l{k}", getattr(net, f"{n}_l{k}").grad,
                          getattr(rnn.cell, n).grad))
    errs, scales = {}, {}
    for name, a, b in pairs:
        errs[name] = float((a - b).abs().max())
        scales[name] = float(b.abs().max())
        ok = errs[name] <= 1e-5 * scales[name] if name.startswith("grad") \
            else bool(torch.isclose(a, b, rtol=1e-5, atol=1e-5).all())
        check(ok, f"nn.LSTM against nn.RNN(nn.LSTMCell): {name} differs by "
              f"{errs[name]} (its largest element {scales[name]})")
    out = {"lstm_cell_equivalence": {
        "shape": [LS_BATCH, LS_MAX_LEN, LS_D], "layers": LS_LAYERS,
        "tol": 1e-5, "max_abs_err": errs, "max_abs": scales}}
    log(json.dumps(out))
    return out


def lstm_reference_check(dev):
    """Phase 32's f32 check (TF32 off): the path at full width and depth,
    batch LS_REF_BATCH, dropout 0, REF_STEPS steps on the kernel path
    (rows 6-7) against the plain path (every kernel flag ``never``) from
    the same seeded weights: losses and parameters within REF_TOL."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.core.flags import flags_guard
    counters = ls_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    rng = np.random.default_rng(SEED + 165)
    runs = {}
    for path, flags in (("kernel", {}), ("plain", LS_PLAIN_FLAGS)):
        with flags_guard(**flags):
            paddle.seed(SEED + 166)
            with paddle.utils.unique_name.guard():
                m = ls_model(paddle, dropout=0.0)
            if not runs:
                bs = [ls_batch(paddle, rng, LS_REF_BATCH) for _ in range(2)]
            step = ls_step_fn(paddle, m, ls_optimizer(paddle, m), bs)
            mark = {k: fn.launches for k, fn in counters.items()}
            losses = [float(step()) for _ in range(REF_STEPS)]
            torch.cuda.synchronize()
            runs[path] = (m, losses, {k: fn.launches - mark[k]
                                      for k, fn in counters.items()})
    (mk, lk, nk), (mp, lp, np_) = runs["kernel"], runs["plain"]
    for k in counters:
        counters[k].launches = before[k]
    check(nk["softmax"] > 0 and nk["fused_adam"] == REF_STEPS,
          f"the kernel path skipped a kernel: {nk}")
    check(all(n == 0 for n in np_.values()), f"the plain path launched a "
          f"kernel: {np_}")
    loss_err = max(abs(a - c) for a, c in zip(lk, lp))
    sk, sp = mk.state_dict(), mp.state_dict()
    param_err = max(float((sk[k] - sp[k]).abs().max()) for k in sk)
    out = {"lstm_seq2seq_reference": {
        "batch": LS_REF_BATCH, "dtype": "float32", "tf32": False,
        "steps": REF_STEPS, "losses_kernel": lk, "losses_plain": lp,
        "max_loss_err": loss_err, "max_param_err": param_err,
        "tol": REF_TOL, "kernel_launches": nk}}
    log(json.dumps(out))
    check(loss_err <= REF_TOL, f"lstm seq2seq reference: losses differ by "
          f"{loss_err}: {lk} vs {lp}")
    check(param_err <= REF_TOL, f"lstm seq2seq reference: params differ "
          f"by {param_err}")
    del runs, mk, mp
    torch.cuda.empty_cache()
    return out


def lstm_decode_phase(dev, model):
    """Phase 33 (the module docstring): beam search with phase 32's
    weights in f32, with the end token, and with an end token past the
    vocabulary, so that every sentence runs to the step limit."""
    import paddle1_tpu_torch as paddle
    b = ls_tensors(paddle, ls_path_arrays()[1])
    ls_decode(paddle, model, b["src"], LS_BEAM, 2)   # warm-up
    out = {"decode": "lstm_seq2seq_beam_search", "dtype": "float32",
           "beam": LS_BEAM, "sentences": LS_BEAM_BATCH,
           "longest_source": b["src_steps"],
           "max_step_num": LS_BEAM_MAX_STEP}
    for tag, end in (("end_token", LS_EOS), ("length_limit", LS_TGT_VOCAB)):
        out[tag] = ls_beam_run(paddle, model, b, end)
        r = out[tag]
        log(f"lstm beam search ({tag}): {r['ms_per_step']:.3f} ms a step "
            f"over {r['steps']} steps, {r['sentences_per_s']:.2f} "
            f"sentences/s, idle {r['device_idle_share']:.3f} "
            f"({card_line()})")
    check(out["length_limit"]["steps"] == LS_BEAM_MAX_STEP + 1,
          f"beam search at the step limit made "
          f"{out['length_limit']['steps']} steps, want "
          f"{LS_BEAM_MAX_STEP + 1}")
    log(json.dumps({"lstm_beam_search": out}))
    return out


def ls_beam_run(paddle, model, b, end):
    """One beam search over batch ``b``: timed with the counters zeroed
    just before and read just after (one row-7 launch a decode step, at
    ``[B x beam, 1, S]``; nothing else), profiled once, then traced on the
    kernel path and the plain path, whose ids must be equal, or part only
    at a near tie (:func:`beam_divergence`)."""
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.ops import softmax as psm
    src = b["src"]
    counters = ls_counters()
    shapes = []
    real = psm.softmax_fwd

    def recording(x):
        shapes.append(tuple(x.shape))
        return real(x)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = ls_decode(paddle, model, src, LS_BEAM, LS_BEAM_MAX_STEP, end)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_steps = int(ids.shape[1])
    check(list(ids.shape) == [LS_BEAM_BATCH, n_steps, LS_BEAM] and
          1 <= n_steps <= LS_BEAM_MAX_STEP + 1, f"beam search: ids of shape "
          f"{list(ids.shape)}")
    want = {k: 0 for k in counters}
    want["softmax"] = n_steps
    for k, n in want.items():
        check(launches[k] == n, f"lstm beam search: {k} launched "
              f"{launches[k]} times over {n_steps} steps, want {n}")
    psm.softmax_fwd = recording
    try:
        ls_decode(paddle, model, src, LS_BEAM, 1, end)
    finally:
        psm.softmax_fwd = real
    want_shape = (LS_BEAM_BATCH * LS_BEAM, 1, b["src_steps"])
    check(shapes and all(s == want_shape for s in shapes),
          f"lstm beam search: row 7 ran at {shapes}, want {want_shape}")
    check((want_shape[0], want_shape[2]) in ls_sm_shapes(),
          f"lstm beam search: row 7's shape {want_shape} is not held alone")
    prof = device_kernels_per_step(
        lambda: ls_decode(paddle, model, src, LS_BEAM, LS_BEAM_MAX_STEP,
                          end).sum(), 1)
    busy = prof["device_busy_ms_per_step"]
    ids_by_path, traces = {}, {}
    for path, flags in (("kernel", {}), ("plain", LS_PLAIN_FLAGS)):
        with flags_guard(**flags):
            traces[path] = []
            ids_by_path[path] = ls_decode(
                paddle, model, src, LS_BEAM, LS_BEAM_MAX_STEP, end,
                traced_beam_decoder(paddle, traces[path]))
    ik, ip = ids_by_path["kernel"], ids_by_path["plain"]
    equal = ik.shape == ip.shape and torch.equal(ik, ip)
    divergence = beam_divergence(traces["kernel"], traces["plain"], LS_BEAM,
                                 LS_TGT_VOCAB)
    check(equal or divergence is not None, "lstm beam search: the paths' "
          "ids differ but their steps chose alike")
    if divergence is not None:
        d = divergence
        gaps = (d["gap_kernel"], d["gap_plain"])
        log(f"lstm beam search: the kernel and plain paths part at step "
            f"{d['step']} of sentence {d['sentence']}, rank {d['rank']}: "
            f"{d['kernel_choice']} against {d['plain_choice']} ([parent, "
            f"token]), {gaps[0]} apart on the kernel path, {gaps[1]} on "
            f"the plain path (the paths' scores {d['score_err_before']:.3e} "
            f"apart before it)")
        check(None not in gaps and max(gaps) <= LOGIT_TOL and
              d["score_err_before"] <= LOGIT_TOL,
              f"lstm beam search: the paths part where the swapped "
              f"candidates are not a near tie within {LOGIT_TOL}: {d}")
    return {"end_token": end, "steps": n_steps, "seconds": dt,
            "ms_per_step": dt * 1e3 / n_steps,
            "sentences_per_s": LS_BEAM_BATCH / dt,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (dt * 1e3),
            "kernels_per_decode": prof["kernels_per_step"],
            "launches": launches, "softmax_shape": list(want_shape),
            "beams_ending": float((ids == end).any(1).float().mean()),
            "ids_equal_to_plain": equal, "divergence": divergence,
            "tolerance": LOGIT_TOL, "top_kernels": prof["top_kernels"]}


# ---------------------------------------------------------------------------
# phases 34-35: the input pipeline (io.DataLoader over vision.datasets and
# vision.transforms) feeding ResNet-50 (BASELINE config 2) and LeNet on
# MNIST (BASELINE config 1)

IO_CLASSES, IO_IMAGES, IO_MIN_PX, IO_MAX_PX = 64, 320, 256, 512
IO_BATCH, IO_EPOCHS, IO_WARMUP, IO_PROFILED = 32, 2, 2, 2
IO_MEAN, IO_STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
IO_RESUME_AT = 4                      # batches consumed before state_dict()
IO_KILL = "loader_worker_kill@2:1"   # worker 1, its second task
IO_EVAL_BATCHES = 3
MNIST_TRAIN, MNIST_TEST, MNIST_BATCH = 60000, 10000, 64
MNIST_LOSS_WINDOW = 100
MNIST_PROBE_STEPS = 100               # the staged and one-worker timings


def io_workers():
    """W = min(8, cores - 1): one core stays with the training loop."""
    import os
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def io_tree(root, classes=IO_CLASSES, images=IO_IMAGES, lo=IO_MIN_PX,
            hi=IO_MAX_PX, seed=SEED + 200):
    """A seeded ``DatasetFolder`` tree under ``root``: ``classes`` class
    folders holding ``images`` uint8 HWC ``.npy`` images in turn, height
    and width drawn from [lo, hi]. Returns the bytes written."""
    import os
    rng = np.random.default_rng(seed)
    total = 0
    for c in range(classes):
        os.makedirs(os.path.join(root, f"n{c:08d}"))
    for i in range(images):
        h, w = rng.integers(lo, hi + 1, 2)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.save(os.path.join(root, f"n{i % classes:08d}",
                             f"img_{i:05d}.npy"), img)
        total += img.nbytes
    return total


def io_train_transform(paddle, size=RN_IMG):
    """PaddleClas's ResNet50 ImageNet training recipe."""
    T = paddle.vision.transforms
    return T.Compose([T.RandomResizedCrop(size), T.RandomHorizontalFlip(),
                      T.Transpose(), T.Normalize(mean=IO_MEAN, std=IO_STD,
                                                 data_format="CHW")])


def io_eval_transform(paddle, size=RN_IMG):
    """The deterministic eval pipeline: Resize(256), CenterCrop(224)."""
    T = paddle.vision.transforms
    return T.Compose([T.Resize(size * 8 // 7), T.CenterCrop(size),
                      T.Transpose(), T.Normalize(mean=IO_MEAN, std=IO_STD,
                                                 data_format="CHW")])


def io_folder(paddle, root, transform):
    return paddle.vision.datasets.DatasetFolder(
        root, loader=np.load, extensions=(".npy",), transform=transform)


def io_epoch_indices(loader):
    """The index batches of ``loader``'s live epoch, from the epoch seed in
    its ``state_dict()`` (the JAX package's order for that seed)."""
    seed = loader.state_dict()["sampler"]["sampler"]["seed"]
    order = np.random.RandomState(seed).permutation(len(loader.dataset))
    b = loader.batch_size
    return seed, [order[k * b:(k + 1) * b] for k in range(len(loader))]


def io_seeded(loader, seed):
    """``loader`` set to replay the epoch of ``seed`` from its start."""
    loader.set_state_dict({"version": 1, "epoch": 0, "cursor": 0,
                           "sampler": {"sampler": {"seed": int(seed)}}})
    return loader


def io_leaves(batch):
    """A loader batch as a tuple of tensors (a one-field batch comes out
    of the worker processes as the tensor itself)."""
    return tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)


def io_host(batch):
    return tuple(t.cpu().numpy() for t in io_leaves(batch))


def io_run(loader, on_batch=None, stop=None):
    """One epoch of ``loader``: each batch checked on the card and copied
    to the host; ``on_batch(k, loader)`` after batch ``k``; the iterator
    shut down in the end. Returns (iterator kind, host batches)."""
    it = iter(loader)
    out = []
    try:
        for k, batch in enumerate(it):
            check(all(t.device.type == CARD for t in io_leaves(batch)),
                  f"a loader batch is not on the card: "
                  f"{[t.device for t in io_leaves(batch)]}")
            out.append(io_host(batch))
            if on_batch is not None:
                on_batch(k, loader)
            if stop is not None and len(out) == stop:
                break
        return type(it).__name__, out
    finally:
        it.shutdown()


def io_equal(got, want, what):
    check(len(got) == len(want), f"{what}: {len(got)} batches, want "
          f"{len(want)}")
    for k, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            check(a.dtype == b.dtype and a.shape == b.shape and
                  np.array_equal(a, b), f"{what}: batch {k} differs "
                  f"({a.dtype} {a.shape} against {b.dtype} {b.shape})")


class IoProbe:
    """What a worker sees: its id, whether its place is the CPU, where a
    ``to_tensor`` lands there, and its pid."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import os
        import paddle1_tpu_torch as paddle
        info = paddle.io.get_worker_info()
        made = paddle.to_tensor(np.zeros(1, np.float32)).device.type
        return np.array([-1 if info is None else info.id,
                         paddle.get_device().kind == "cpu", made == "cpu",
                         os.getpid()], np.int64)


def io_step_times(step, n):
    """``n`` steps, each timed end to end on the host clock (the wait in
    ``next`` included, the loss read back): (step ms, wait ms, losses)."""
    steps, waits, losses = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out = step()
        if out is None:
            break
        wait_s, loss = out
        losses.append(float(loss))
        steps.append((time.perf_counter() - t0) * 1e3)
        waits.append(wait_s * 1e3)
    return steps, waits, losses


def io_resnet_phase(dev, rn_step_ms=None, classes=IO_CLASSES,
                    images=IO_IMAGES, lo=IO_MIN_PX, hi=IO_MAX_PX,
                    img=RN_IMG, batch=IO_BATCH, workers=None,
                    make_model=None):
    """Phase 34: ResNet-50 training fed by the DataLoader with W worker
    processes over a seeded ``.npy`` ImageFolder tree, then the exact
    checks on the deterministic eval pipeline."""
    import os
    import tempfile
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.core import chaos
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet50
    W = workers or io_workers()
    cores = os.cpu_count()
    log(f"io: {W} loader workers on {cores} cores")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        tree_bytes = io_tree(root, classes, images, lo, hi)
        tree_s = time.perf_counter() - t0
        train_ds = io_folder(paddle, root, io_train_transform(paddle, img))
        check(len(train_ds) == images and
              len(train_ds.classes) == classes, f"the tree holds "
              f"{len(train_ds)} images in {len(train_ds.classes)} classes")
        loader = paddle.io.DataLoader(train_ds, batch_size=batch,
                                      shuffle=True, drop_last=True,
                                      num_workers=W, use_shared_memory=True)
        gen = torch.Generator().manual_seed(SEED + 201)
        model = (make_model or (lambda: resnet50(generator=gen)))()
        eng = ParallelEngine(model, Momentum(learning_rate=RN_LR,
                                             momentum=0.9,
                                             parameters=model.parameters()),
                             rn_loss_fn, amp_dtype="bfloat16")
        counters = bn_counters()
        kinds, live, steps, waits, losses = [], [], [], [], []
        zero(counters)
        for _ in range(IO_EPOCHS):
            it = iter(loader)
            try:
                kinds.append(type(it).__name__)
                live.append(sum(p.is_alive() for p in
                                getattr(it, "_workers", [])))

                def step():
                    t0 = time.perf_counter()
                    try:
                        x, y = next(it)
                    except StopIteration:
                        return None
                    wait = time.perf_counter() - t0
                    return wait, eng.step({"x": x, "y": y})
                s, w, l_ = io_step_times(step, len(loader) + 1)
                steps += s
                waits += w
                losses += l_
            finally:
                it.shutdown()
        torch.cuda.synchronize()
        train = bn_launches(counters)
        n = len(losses)
        check(n == IO_EPOCHS * (images // batch), f"{n} fed steps, want "
              f"{IO_EPOCHS * (images // batch)}")
        want = {"fused_bn_train": RN_BNS * n, "fused_bn_norm": 0,
                "fused_bn_train_bwd": RN_BNS * n, "fused_bn_norm_bwd": 0}
        check(train == want, f"fed training launches {train}, want {want} "
              f"({n} steps)")
        check(all(np.isfinite(losses)), f"non-finite fed loss {losses}")
        check(kinds == ["_MultiProcessIter"] * IO_EPOCHS and
              live == [W] * IO_EPOCHS, f"the fed epochs ran {kinds} with "
              f"{live} live workers, want _MultiProcessIter with {W}")
        # two more steps under torch.profiler, on a fresh epoch's pipeline
        it, last = iter(loader), []
        try:
            def prof_step():
                x, y = last[:] = next(it)
                return eng.step({"x": x, "y": y})
            for _ in range(IO_WARMUP):
                float(prof_step())
            prof = device_kernels_per_step(prof_step, IO_PROFILED)
        finally:
            it.shutdown()
        dt = float(np.median(steps[IO_WARMUP:]))
        busy = prof["device_busy_ms_per_step"]
        # the same protocol on one batch staged on the card: the loader's
        # share of the fed step
        staged_batch = {k: t.as_subclass(torch.Tensor).clone()
                        for k, t in zip("xy", last)}
        staged, _, _ = io_step_times(
            lambda: (0.0, eng.step(staged_batch)), IO_WARMUP + 10)
        staged_ms = float(np.median(staged[IO_WARMUP:]))

        # the exact checks, on the deterministic eval pipeline
        eval_ds = io_folder(paddle, root, io_eval_transform(paddle, img))
        cache = {}

        def want_batches(index_batches):
            out = []
            for idx in index_batches:
                for i in idx:
                    if i not in cache:
                        cache[i] = eval_ds[i]
                out.append((np.stack([cache[i][0] for i in idx]),
                            np.stack([cache[i][1] for i in idx])))
            return out

        def eval_loader(workers):
            return paddle.io.DataLoader(eval_ds, batch_size=batch,
                                        shuffle=True, drop_last=True,
                                        num_workers=workers)
        # (a) with W workers, and the resume state after IO_RESUME_AT
        ev = eval_loader(W)
        mid = {}

        def at(k, ldr):
            if k == 0:
                mid["seed"], mid["indices"] = io_epoch_indices(ldr)
            if k + 1 == IO_RESUME_AT:
                mid["state"] = ldr.state_dict()
        t1 = time.perf_counter()
        kind_w, got_w = io_run(ev, at)
        eval_loader_s = time.perf_counter() - t1
        check(kind_w == "_MultiProcessIter", f"the eval loader ran {kind_w}")
        want = want_batches(mid["indices"])
        io_equal(got_w, want, f"{W}-worker batches against np.stack of "
                 "ds[i]")
        kind_0, got_0 = io_run(io_seeded(eval_loader(0), mid["seed"]))
        check(kind_0 == "_SingleProcessIter", f"num_workers=0 ran {kind_0}")
        io_equal(got_0, want, "num_workers=0 batches against np.stack of "
                 "ds[i]")
        # (c) resume after IO_RESUME_AT batches into a fresh loader
        check(mid["state"]["cursor"] == IO_RESUME_AT, f"state after "
              f"{IO_RESUME_AT} batches: {mid['state']}")
        fresh = eval_loader(W)
        fresh.set_state_dict(mid["state"])
        _, rest = io_run(fresh)
        io_equal(rest, got_w[IO_RESUME_AT:], "the resumed loader's batches")
        # (d) worker 1 killed once: replaced, the epoch in order
        chaos.configure(IO_KILL)
        try:
            killed = io_seeded(eval_loader(W), mid["seed"])
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, got_k = io_run(killed)
        finally:
            chaos.reset()
        check(killed.worker_restart_count == 1, f"worker restarts "
              f"{killed.worker_restart_count} after {IO_KILL}, want 1")
        io_equal(got_k, got_w, "the killed-worker epoch's batches")
        # (b) the workers' place
        probe = paddle.io.DataLoader(IoProbe(4 * W), batch_size=1,
                                     num_workers=W)
        _, rows = io_run(probe)
        rows = np.concatenate([r[0] for r in rows])
        check(sorted(set(rows[:, 0].tolist())) == list(range(W)) and
              bool(rows[:, 1].all()) and bool(rows[:, 2].all()) and
              len(set(rows[:, 3].tolist())) == W and
              os.getpid() not in rows[:, 3].tolist(),
              f"worker probe: {rows.tolist()}")
        # (e) an eval forward over the loader: 53 row-9 launches a forward
        model.eval()
        zero(counters)
        n_eval = 0
        it = iter(eval_loader(W))
        try:
            with paddle.no_grad():
                for _ in range(IO_EVAL_BATCHES):
                    x, _y = next(it)
                    logits = model(x)
                    n_eval += 1
                    check(tuple(logits.shape) == (batch, 1000) and
                          bool(torch.isfinite(logits).all()),
                          "fed eval logits not finite [batch, 1000]")
        finally:
            it.shutdown()
        torch.cuda.synchronize()
        evals = bn_launches(counters)
        want = {"fused_bn_train": 0, "fused_bn_norm": RN_BNS * n_eval,
                "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": 0}
        check(evals == want, f"fed eval launches {evals}, want {want}")
    summary = {
        "train": "resnet50_fed_by_dataloader", "amp": "bfloat16",
        "batch": batch, "img": img, "classes": classes, "images": images,
        "tree_bytes": tree_bytes, "tree_write_s": tree_s,
        "workers": W, "cpu_cores": cores, "iterators": kinds,
        "live_workers": live, "steps": n, "warmup_steps": IO_WARMUP,
        "timing": "host clock per step, next() included, loss read back",
        "step_ms_median": dt, "step_ms_min": min(steps[IO_WARMUP:]),
        "step_ms_max": max(steps[IO_WARMUP:]),
        "loader_wait_ms_median": float(np.median(waits[IO_WARMUP:])),
        "loader_wait_ms_max": max(waits[IO_WARMUP:]),
        "samples_per_s": batch / dt * 1e3,
        "phase9_step_ms_median": rn_step_ms,
        "staged_step_ms_median": staged_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / dt,
        "profiler_window_idle_share": 1.0 - busy / prof["profiled_step_ms"],
        "kernels_per_step": prof["kernels_per_step"],
        "loss_first": losses[:2], "loss_last": losses[-2:],
        "launches_train": train,
        "launches_per_step": {k: v / n for k, v in train.items()},
        "launches_eval": evals, "eval_forwards": n_eval,
        "eval_epoch_s_with_workers": eval_loader_s,
        "checks": ["W-worker and num_workers=0 batches exact",
                   "resume after 4 batches exact",
                   f"{IO_KILL}: 1 restart, batches exact",
                   "every worker on the CPU place"],
        "profile": prof}
    log(f"io resnet50: {dt:.1f} ms a fed step (staged, the same timing: "
        f"{staged_ms:.1f} ms; phase 9: "
        f"{rn_step_ms if rn_step_ms is None else round(rn_step_ms, 1)} ms), "
        f"loader wait {summary['loader_wait_ms_median']:.1f} ms, "
        f"{summary['samples_per_s']:.0f} samples/s, busy {busy:.1f} ms, "
        f"idle {summary['device_idle_share']:.3f}, {W} workers on {cores} "
        f"cores ({card_line()})")
    log(json.dumps({"io_resnet50": summary}))
    del eng, model
    return summary


def mnist_labels(images, seed=SEED + 210):
    """Each label a fixed function of its image: the argmax of 10 seeded
    projections (7 x 7 patterns upsampled to 28 x 28) of the centred
    image."""
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((10, 7, 7)).astype(np.float32)
    proj = np.kron(coarse, np.ones((4, 4), np.float32)).reshape(10, 784).T
    out = np.empty(len(images), np.uint8)
    for s in range(0, len(images), 8192):
        x = images[s:s + 8192].reshape(-1, 784).astype(np.float32)
        out[s:s + 8192] = np.argmax((x / 255.0 - 0.5) @ proj, 1)
    return out


def write_mnist(root, n, split, seed):
    """``n`` seeded images and their labels in MNIST's IDX files, gzipped
    (``train-images-idx3-ubyte.gz`` and its labels, or ``t10k-...``)."""
    import gzip
    import os
    import struct
    images = np.random.default_rng(seed).integers(0, 256, (n, 28, 28),
                                                  dtype=np.uint8)
    labels = mnist_labels(images)
    img_p = os.path.join(root, f"{split}-images-idx3-ubyte.gz")
    lab_p = os.path.join(root, f"{split}-labels-idx1-ubyte.gz")
    with gzip.open(img_p, "wb", compresslevel=1) as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(images.tobytes())
    with gzip.open(lab_p, "wb", compresslevel=1) as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    return img_p, lab_p, images, labels


def io_lenet_phase(dev, lenet_step_ms=None, n_train=MNIST_TRAIN,
                   n_test=MNIST_TEST, batch=MNIST_BATCH):
    """Phase 35: Paddle 2.0's quick start, eager LeNet on MNIST through
    ``vision.datasets.MNIST`` and ``io.DataLoader(shuffle=True)`` (the
    single-process iterator and its staging thread) for one epoch; the
    batches of a second pass exact; the test set through ``F.softmax``."""
    import tempfile
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.ops import fused_adam as fad
    from paddle1_tpu_torch.ops import softmax as psm
    from paddle1_tpu_torch.vision.models import LeNet
    F = paddle.nn.functional
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        img_p, lab_p, images, labels = write_mnist(root, n_train, "train",
                                                   SEED + 211)
        timg_p, tlab_p, _, tlabels = write_mnist(root, n_test, "t10k",
                                                 SEED + 212)
        write_s = time.perf_counter() - t0
        T = paddle.vision.transforms
        norm = T.Normalize(mean=[127.5], std=[127.5], data_format="CHW")
        t0 = time.perf_counter()
        train = paddle.vision.datasets.MNIST(img_p, lab_p, mode="train",
                                             transform=norm)
        test = paddle.vision.datasets.MNIST(timg_p, tlab_p, mode="test",
                                            transform=norm)
        parse_s = time.perf_counter() - t0
    check(len(train) == n_train and len(test) == n_test, "MNIST sizes "
          f"{len(train)}, {len(test)}")
    loader = paddle.io.DataLoader(train, batch_size=batch, shuffle=True)
    paddle.seed(SEED)
    model = LeNet()
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters())
    counters = {"fused_adam": fad.fused_adam_, "softmax": psm.fused_softmax}
    for fn in counters.values():
        fn.launches = 0
    def fed_step(it):
        def step():
            t0 = time.perf_counter()
            try:
                x, y = next(it)
            except StopIteration:
                return None
            wait = time.perf_counter() - t0
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return wait, loss
        return step
    it = iter(loader)
    kind = type(it).__name__
    t0 = time.perf_counter()
    try:
        steps, waits, losses = io_step_times(fed_step(it), len(loader) + 1)
    finally:
        it.shutdown()
    epoch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    n = len(losses)
    check(kind == "_SingleProcessIter", f"the MNIST loader ran {kind}")
    check(n == -(-n_train // batch), f"{n} steps in the epoch, want "
          f"{-(-n_train // batch)}")
    check(launches == {"fused_adam": n, "softmax": 0}, f"{n} fed steps "
          f"launched {launches}, want {n} fused Adam and no softmax")
    check(all(np.isfinite(losses)), "non-finite fed LeNet loss")
    w = min(MNIST_LOSS_WINDOW, n // 2)
    first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    check(last < first, f"the mean loss of the last {w} steps {last} is "
          f"not below the first {w}'s {first}")
    # two more steps under torch.profiler
    it = iter(loader)
    try:
        def prof_step():
            x, y = next(it)
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        for _ in range(IO_WARMUP):
            float(prof_step())
        prof = device_kernels_per_step(prof_step, IO_PROFILED)
    finally:
        it.shutdown()
    dt = float(np.median(steps[IO_WARMUP:]))
    busy = prof["device_busy_ms_per_step"]
    # where the fed step's time goes: the same timing on two batches
    # staged on the card (no loader), and fed by one worker process (the
    # parent's thread does no sample work, so it holds the GIL alone)
    head = iter(paddle.io.DataLoader(train, batch_size=batch))
    try:
        staged_batches = [tuple(t.clone() for t in next(head))
                          for _ in range(2)]
    finally:
        head.shutdown()
    turn = [0]

    def staged_step():
        x, y = staged_batches[turn[0] % 2]
        turn[0] += 1
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return 0.0, loss
    staged, _, _ = io_step_times(staged_step, IO_WARMUP + MNIST_PROBE_STEPS)
    it = iter(paddle.io.DataLoader(train, batch_size=batch, shuffle=True,
                                   num_workers=1))
    try:
        worker_kind = type(it).__name__
        worker_fed, worker_waits, _ = io_step_times(
            fed_step(it), IO_WARMUP + MNIST_PROBE_STEPS)
    finally:
        it.shutdown()
    # a second pass: every batch equals the IDX arrays at its indices
    it = iter(loader)
    try:
        seed = loader.state_dict()["sampler"]["sampler"]["seed"]
        order = np.random.RandomState(seed).permutation(n_train)
        k = 0
        for x, y in it:
            idx = order[k * batch:(k + 1) * batch]
            want_x = (images[idx][:, None].astype(np.float32) -
                      np.float32(127.5)) / np.float32(127.5)
            check(x.device.type == CARD and y.device.type == CARD,
                  "an MNIST batch is not on the card")
            check(np.array_equal(x.cpu().numpy(), want_x) and
                  np.array_equal(y.cpu().numpy(),
                                 labels[idx][:, None].astype(np.int64)),
                  f"MNIST batch {k} differs from the IDX arrays")
            k += 1
    finally:
        it.shutdown()
    check(k == n, f"the second pass gave {k} batches, want {n}")
    # the test set: one row-7 launch a batch
    for fn in counters.values():
        fn.launches = 0
    correct, batches = 0, 0
    with paddle.no_grad():
        for x, y in paddle.io.DataLoader(test, batch_size=batch):
            probs = F.softmax(model(x))
            correct += int((probs.argmax(-1) == y[:, 0]).sum())
            batches += 1
    torch.cuda.synchronize()
    test_launches = {k: fn.launches for k, fn in counters.items()}
    check(test_launches == {"fused_adam": 0, "softmax": batches},
          f"the test pass launched {test_launches}, want {batches} softmax")
    acc = correct / n_test
    summary = {
        "train": "lenet_mnist_fed_by_dataloader", "batch": batch,
        "images": n_train, "test_images": n_test, "iterator": kind,
        "files_write_s": write_s, "parse_s": parse_s,
        "steps": n, "warmup_steps": IO_WARMUP,
        "timing": "host clock per step, next() included, loss read back",
        "step_ms_median": dt, "step_ms_min": min(steps[IO_WARMUP:]),
        "step_ms_max": max(steps[IO_WARMUP:]),
        "loader_wait_ms_median": float(np.median(waits[IO_WARMUP:])),
        "loader_wait_ms_max": max(waits[IO_WARMUP:]),
        "epoch_s": epoch_s, "images_per_s": batch / dt * 1e3,
        "phase15_step_ms_median": lenet_step_ms,
        "staged_step_ms_median": float(np.median(staged[IO_WARMUP:])),
        "one_worker": {"iterator": worker_kind, "steps": MNIST_PROBE_STEPS,
                       "step_ms_median": float(np.median(
                           worker_fed[IO_WARMUP:])),
                       "loader_wait_ms_median": float(np.median(
                           worker_waits[IO_WARMUP:]))},
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / dt,
        "profiler_window_idle_share": 1.0 - busy / prof["profiled_step_ms"],
        "kernels_per_step": prof["kernels_per_step"],
        "loss_first_mean": first, "loss_last_mean": last,
        "loss_window": w, "launches": launches,
        "test_batches": batches, "test_launches": test_launches,
        "test_accuracy": acc, "label_counts": np.bincount(
            labels, minlength=10).tolist(),
        "profile": prof}
    log(f"io lenet: {dt:.3f} ms a fed step (staged, the same timing: "
        f"{summary['staged_step_ms_median']:.3f} ms; one worker process: "
        f"{summary['one_worker']['step_ms_median']:.3f} ms; phase 15: "
        f"{lenet_step_ms} ms), "
        f"loader wait {summary['loader_wait_ms_median']:.3f} ms, "
        f"{summary['images_per_s']:.0f} images/s, idle "
        f"{summary['device_idle_share']:.3f}, loss {first:.4f} -> "
        f"{last:.4f}, test accuracy {acc:.4f} ({card_line()})")
    log(json.dumps({"io_lenet": summary}))
    return summary


# ---------------------------------------------------------------------------
# phases 36-38: generation economics and the batch Server

# phase 36's teacher-forced logits against the plain forward: four f16
# rounding steps of the largest logit. In the f16-cache arm only K and V
# round to f16 (2^-11 relative each) and the rest stays f32; in the f16
# model every matrix product and LayerNorm rounds its output once, and
# the logits themselves are f16, so the kernel path and the plain path
# (other kernels, other summation orders) may land one to a few units in
# the last place of the largest logit apart
F16_LOGIT_REL = 2.0 ** -8
# phase 37's int8 logits against a plain forward on the dequantized
# weights: the same f32 arithmetic, the kernels' summation orders
INT8_LOGIT_TOL = 1e-3
SPEC_K, RESUME_AT = 4, 10
# phase 37's preemption pool: 40 pages of 16 rows for 16 slots (the dense
# equivalent is 16 * 32 + 1), priorities 0-2, the pool squatted by chaos
# at the fifth scheduler tick
PREEMPT_PAGES, PREEMPT_CHAOS = 40, "gen_page_pressure@5"
WEDGE_CHAOS = "gen_slot_wedge@6:1"
# phase 38: ResNet-50 eval behind the batch Server (Paddle Serving's
# ResNet50 example's online classification), f32, channels-last
RS_BUCKETS, RS_MAX_BATCH, RS_TIMEOUT_MS = (1, 2, 4, 8, 16, 32), 32, 5.0
RS_REQUESTS, RS_CLIENTS, RS_TOL = 256, 4, 1e-4


def gen_counters():
    from paddle1_tpu_torch.ops import layer_norm as ln
    from paddle1_tpu_torch.ops import paged_attention as pa
    return {"paged_attention": pa.paged_attention,
            "layer_norm": ln.fused_layer_norm}


def gen_model(dtype=None):
    """The README's CausalLM with phase 3's seeded weights, on the card
    (in ``dtype`` when given)."""
    from paddle1_tpu_torch.serving import CausalLM
    lm = CausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, dim_feedforward=FFN,
                  num_layers=LAYERS, max_seq=MAX_SEQ,
                  generator=torch.Generator().manual_seed(SEED))
    return lm if dtype is None else lm.astype(dtype)


def gen_engine(lm, **kw):
    from paddle1_tpu_torch.serving import GenerationEngine
    return GenerationEngine(lm, slots=SLOTS, max_seq=MAX_SEQ, eos_id=2,
                            paged=True, page_size=PAGE, **kw)


def gen_serve(eng, reqs, tag, preempt=False):
    """Phase 3's staggered serving of ``reqs`` through a fresh server on
    ``eng``, the counters zeroed just before and read just after, with
    phase 3's gates: nothing unaccounted or owed, every stream complete,
    paged attention once per layer a decode step, LayerNorm twice per
    layer a step and a prefill."""
    from paddle1_tpu_torch.serving import GenerationServer
    counters = gen_counters()
    srv = GenerationServer(eng, queue_depth=64, warmup=True,
                           preempt=preempt).start()
    torch.cuda.synchronize()
    steps0 = eng.decode_dispatch_count
    prefills0 = sum(eng.prefill_dispatch_counts.values())
    zero(counters)
    t0 = time.perf_counter()
    streams, outs = serve(srv, reqs)
    rep = srv.drain(timeout=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bn_launches(counters)
    check(rep["fatal"] is None, f"{tag}: generation loop died: "
          f"{rep['fatal']}")
    for key in ("unaccounted", "kv_pages_owed", "tokens_owed"):
        check(rep[key] == 0, f"{tag}: {key}={rep[key]}")
    check(rep["completed"] == len(reqs), f"{tag}: completed "
          f"{rep['completed']} of {len(reqs)}")
    for st, out, (_, kw) in zip(streams, outs, reqs):
        check(st.finish_reason in ("eos", "length"),
              f"{tag}: stream finished {st.finish_reason}")
        check(1 <= len(out) <= kw["max_new_tokens"] and
              all(0 <= t < VOCAB for t in out), f"{tag}: bad stream")
    steps = rep["decode_dispatches"] - steps0
    prefills = sum(rep["prefill_dispatch_counts"].values()) - prefills0
    check(launches["paged_attention"] == LAYERS * steps,
          f"{tag}: paged_attention launched {launches['paged_attention']} "
          f"times, want {LAYERS} per decode step x {steps}")
    check(launches["layer_norm"] == 2 * LAYERS * (steps + prefills),
          f"{tag}: layer_norm launched {launches['layer_norm']} times, want "
          f"{2 * LAYERS} per step x {steps + prefills}")
    snap = srv.metrics.snapshot()
    h, c = snap["histograms"], snap["counters"]
    summary = {
        "arm": tag, "requests": len(reqs),
        "tokens_generated": rep["tokens_generated"], "decode_steps": steps,
        "prefills": prefills, "wall_s": wall,
        "tokens_per_s": rep["tokens_generated"] / wall,
        "decode_step_ms_p50": h["decode_step_ms"]["p50"],
        "decode_step_ms_p99": h["decode_step_ms"]["p99"],
        "prefill_ms_mean": h["prefill_ms"]["mean"],
        "launches": launches, "unaccounted": rep["unaccounted"],
        "kv_pages_owed": rep["kv_pages_owed"]}
    if c.get("gen_spec_proposed_total"):
        summary["spec_proposed"] = c["gen_spec_proposed_total"]
        summary["spec_accepted"] = c.get("gen_spec_accepted_total", 0)
        summary["spec_accept_ratio"] = (summary["spec_accepted"]
                                        / summary["spec_proposed"])
    for k in ("gen_preemptions_total", "gen_preempt_readmits_total",
              "gen_admission_deferrals_total"):
        if c.get(k):
            summary[k] = c[k]
    return streams, outs, summary


def decode_profile(eng, n=8, drafts=None):
    """Every slot busy with a 64-token greedy prompt, then ``n`` decode
    steps timed on the host clock (synchronised) and ``n`` more under
    torch.profiler: ms a step, the device's busy ms a step and its idle
    share against the untraced step. ``drafts(s)`` gives slot s's
    proposals under speculation."""
    rng = np.random.default_rng(SEED + 370)
    for s in range(eng.slots):
        eng.prefill(s, rng.integers(3, VOCAB, 64).astype(np.int32), 0.0, 0,
                    0)
    active = np.ones(eng.slots, bool)
    k = eng.spec_tokens
    d = np.zeros((eng.slots, k), np.int64)
    nd = np.zeros(eng.slots, np.int64)

    def step():
        eng.decode(active, d, nd)
        return torch.zeros((), device=eng.device)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    prof = device_kernels_per_step(step, n, top=6)
    for s in range(eng.slots):
        eng.release(s)
    busy = prof["device_busy_ms_per_step"]
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / step_ms,
            "kernels_per_step": prof["kernels_per_step"],
            "top_kernels": prof["top_kernels"]}


def plain_forward_logits(lm, seq, dev, params=None):
    """The model's plain forward on the card (no cache, dense causal
    attention, no hand-written kernel), on ``params`` when given."""
    from paddle1_tpu_torch.core.flags import flags_guard
    counters = gen_counters()
    before = bn_launches(counters)
    ids = torch.tensor([seq], device=dev)
    with flags_guard(fused_layer_norm="never", pallas_paged_attention="never",
                     flash_attention="never"), torch.inference_mode():
        lg = (lm(ids) if params is None
              else torch.func.functional_call(lm, params, (ids,)))
    check(bn_launches(counters) == before,
          "the plain forward launched a kernel")
    return lg[0].float()


def engine_logits(eng, prompt, n):
    """Teacher-free greedy run of ``prompt`` alone in slot 0 through the
    kernel path: its tokens and each step's f32 logits."""
    toks = [eng.prefill(0, np.asarray(prompt, np.int32), 0.0, 0, 0)]
    lgs = [eng.last_prefill_logits.clone()]
    active = np.zeros([eng.slots], bool)
    active[0] = True
    while len(toks) < n:
        t, _ = eng.decode(active)
        toks.append(int(t[0, 0]))
        lgs.append(eng.last_logits[0].clone())
    eng.release(0)
    return toks, torch.stack(lgs)


def gen_f16_phase(dev, reqs):
    """Phase 36: phase 3's requests served by the README's CausalLM in
    two f16 arms, each with phase 3's gates and launch counts; the
    longest greedy stream re-run alone and its logits held to the plain
    forward of the same model within F16_LOGIT_REL of the largest."""
    out = {}
    for tag, model_dtype, kw in (
            ("f16_cache", None, dict(cache_dtype="float16")),
            ("f16_model", "float16", dict(cache_dtype="float16"))):
        lm = gen_model(model_dtype)
        eng = gen_engine(lm, **kw)
        check(all(k.dtype == torch.float16 for k, _ in eng._kv),
              f"{tag}: the pools are not float16")
        _, outs, summary = gen_serve(eng, reqs, f"gen_{tag}")
        greedy = [i for i, (_, k) in enumerate(reqs)
                  if not k.get("temperature")]
        pick = max(greedy, key=lambda i: len(outs[i]))
        prompt = reqs[pick][0]
        toks, got = engine_logits(eng, prompt, len(outs[pick]))
        check(toks == outs[pick], f"{tag}: greedy request alone differs "
              "from the served stream")
        ref = plain_forward_logits(lm, list(prompt) + toks[:-1],
                                   dev)[len(prompt) - 1:]
        err = float((got - ref).abs().max())
        bound = F16_LOGIT_REL * float(ref.abs().max())
        check(err <= bound, f"{tag}: teacher-forced logits differ by {err} "
              f"> {bound}")
        summary.update(teacher_forced_err=err, teacher_forced_bound=bound,
                       teacher_forced_steps=len(toks),
                       profile=decode_profile(eng))
        out[tag] = summary
        log(json.dumps({"gen_" + tag: summary}))
        del eng, lm
        torch.cuda.empty_cache()
    return out


def spec_draft_run(eng, prompt, kw, want):
    """Drive ``eng`` (spec_tokens = SPEC_K) by hand with a
    DraftModelSpeculator whose drafts are ``want``'s own continuation:
    every draft is accepted, so a window yields SPEC_K + 1 tokens. Returns
    the tokens and the number of windows."""
    from paddle1_tpu_torch.serving import DraftModelSpeculator
    n0 = len(prompt)
    sp = DraftModelSpeculator(prompt, SPEC_K, lambda h, k: want[
        len(h) - n0:len(h) - n0 + k])
    got = [eng.prefill(0, np.asarray(prompt, np.int32),
                       kw.get("temperature", 0.0), kw.get("top_k", 0),
                       kw.get("seed", 0))]
    sp.observe(got[0])
    active = np.zeros([eng.slots], bool)
    active[0] = True
    windows = 0
    while len(got) < len(want):
        d = sp.propose()
        drafts = np.zeros([eng.slots, SPEC_K], np.int64)
        nd = np.zeros([eng.slots], np.int64)
        drafts[0, :d.size] = d
        nd[0] = d.size
        toks, flags = eng.decode(active, drafts, nd)
        windows += 1
        for t in toks[0][flags[0]]:
            sp.observe(int(t))
            got.append(int(t))
    eng.release(0)
    return got[:len(want)], windows


def decode_economics_phase(dev, reqs, ref_outs):
    """Phase 37: speculation, int8 weights, resume replay, KV-pressure
    preemption and slot-wedge chaos at the README width, each against
    phase 3's streams of the same requests (``ref_outs``)."""
    from paddle1_tpu_torch.core import chaos
    from paddle1_tpu_torch.quantization import (QuantTensor,
                                                dequantize_weights)
    from paddle1_tpu_torch.serving import GenerationServer, SlotWedged
    from paddle1_tpu_torch.ops import paged_attention as pa
    out = {}
    lm = gen_model()

    # speculation through the server: n-gram drafts, streams bit-equal
    eng = gen_engine(lm, spec_tokens=SPEC_K)
    _, outs, summary = gen_serve(eng, reqs, "gen_spec")
    for i, (got, want) in enumerate(zip(outs, ref_outs)):
        check(got == want, f"speculative stream {i} differs from the "
              f"non-speculative one: {got[:12]}... != {want[:12]}...")
    summary["profile"] = decode_profile(eng)
    # a draft model proposing the stream's own continuation: every draft
    # taken, one window of W = 5 per five tokens, row 1 once per layer
    drafted = {}
    for name, i in (("greedy", 0), ("sampled", 1)):
        pa.paged_attention.launches = 0
        got, windows = spec_draft_run(eng, reqs[i][0], reqs[i][1],
                                      ref_outs[i])
        torch.cuda.synchronize()
        check(got == ref_outs[i], f"draft-model run ({name}) differs from "
              "the non-speculative stream")
        want_w = -(-(len(ref_outs[i]) - 1) // (SPEC_K + 1))
        check(windows == want_w, f"draft-model run ({name}): {windows} "
              f"windows, want {want_w}")
        check(pa.paged_attention.launches == LAYERS * windows,
              f"draft-model run ({name}): paged_attention launched "
              f"{pa.paged_attention.launches} times, want {LAYERS} x "
              f"{windows}")
        drafted[name] = {"tokens": len(got), "windows": windows,
                         "paged_attention_launches": LAYERS * windows,
                         "dispatch_share": windows / (len(got) - 1)}
    summary["draft_model_runs"] = drafted
    out["spec"] = summary
    log(json.dumps({"gen_spec": summary}))
    del eng

    # int8 weights: logits against a plain forward on the dequantized
    # weights, the stored bytes against f32
    eng = gen_engine(lm, int8=True)
    _, outs, summary = gen_serve(eng, reqs, "gen_int8")
    greedy = [i for i, (_, k) in enumerate(reqs) if not k.get("temperature")]
    pick = max(greedy, key=lambda i: len(outs[i]))
    prompt = reqs[pick][0]
    toks, got = engine_logits(eng, prompt, len(outs[pick]))
    check(toks == outs[pick], "int8: greedy request alone differs from the "
          "served stream")
    deq = dequantize_weights(eng._params)
    ref = plain_forward_logits(lm, list(prompt) + toks[:-1], dev,
                               params=deq)[len(prompt) - 1:]
    err = float((got - ref).abs().max())
    check(err <= INT8_LOGIT_TOL, f"int8 logits differ from the dequantized "
          f"forward by {err} > {INT8_LOGIT_TOL}")
    quant = [v for v in eng._params.values() if isinstance(v, QuantTensor)]
    q_bytes = sum(v.q.numel() + 4 * v.scale.numel() for v in quant)
    f_bytes = sum(4 * v.q.numel() for v in quant)
    rest = sum(v.numel() * v.element_size() for v in eng._params.values()
               if not isinstance(v, QuantTensor))
    summary.update(
        logit_err_vs_dequantized=err, quantized_weights=len(quant),
        weight_bytes_int8=q_bytes, weight_bytes_f32=f_bytes,
        weight_bytes_ratio=q_bytes / f_bytes,
        all_params_bytes_ratio=(q_bytes + rest) / (f_bytes + rest),
        profile=decode_profile(eng))
    out["int8"] = summary
    log(json.dumps({"gen_int8": summary}))
    del eng, deq

    # resume at token RESUME_AT: the continuation equals the stream
    eng = gen_engine(lm)
    srv = GenerationServer(eng, queue_depth=64).start()
    resumed = []
    for i in (0, 1, 3):   # greedy, sampled, sampled
        prompt, kw = reqs[i]
        kw = dict(kw, seed=kw.get("seed", 0))
        got = srv.submit(prompt, resume_tokens=ref_outs[i][:RESUME_AT],
                         **kw).result(timeout=300)
        check(got == ref_outs[i][RESUME_AT:], f"resumed stream {i} differs "
              "from the uninterrupted one")
        resumed.append({"request": i, "sampled": bool(kw.get("temperature")),
                        "tokens": len(got)})
    rep = srv.drain(timeout=300)
    check(rep["unaccounted"] == 0 and rep["kv_pages_owed"] == 0,
          f"resume drain report {rep}")
    out["resume"] = {"at": RESUME_AT, "streams": resumed}
    log(json.dumps({"gen_resume": out["resume"]}))

    # preemption: a pool too small for every slot, priorities, squatted
    chaos.reset()
    chaos.configure(PREEMPT_CHAOS)
    try:
        eng = gen_engine(lm, pages=PREEMPT_PAGES, prefix_cache=0)
        preqs = [(p, dict(kw, priority=i % 3))
                 for i, (p, kw) in enumerate(reqs)]
        _, outs, summary = gen_serve(eng, preqs, "gen_preempt",
                                     preempt=True)
    finally:
        chaos.reset()
    for i, (got, want) in enumerate(zip(outs, ref_outs)):
        check(got == want, f"preempted stream {i} differs from its "
              "unpreempted run")
    check(summary.get("gen_preemptions_total", 0) >= 1 and
          summary.get("gen_preempt_readmits_total", 0) >= 1,
          f"preemption never parked and re-admitted a stream: {summary}")
    summary.update(pages=PREEMPT_PAGES, chaos=PREEMPT_CHAOS)
    out["preempt"] = summary
    log(json.dumps({"gen_preempt": summary}))

    # chaos: a wedged slot fails only its own stream
    chaos.configure(WEDGE_CHAOS)
    try:
        eng = gen_engine(lm)
        srv = GenerationServer(eng, queue_depth=64).start()
        streams = [srv.submit(p, **kw) for p, kw in reqs[:3]]
        results = []
        for st in streams:
            try:
                results.append(st.result(timeout=300))
            except SlotWedged:
                results.append(None)
        rep = srv.drain(timeout=300)
    finally:
        chaos.reset()
    check(results[1] is None and 0 < len(streams[1].tokens),
          "gen_slot_wedge did not fail slot 1's stream mid-stream")
    check(results[0] == ref_outs[0] and results[2] == ref_outs[2],
          "a wedged slot changed its cohabitants' streams")
    check(rep["errors"] == 1 and rep["unaccounted"] == 0 and
          rep["kv_pages_owed"] == 0, f"wedge drain report {rep}")
    out["chaos"] = {"spec": WEDGE_CHAOS, "wedged_tokens":
                    len(streams[1].tokens), "errors": rep["errors"]}
    log(json.dumps({"gen_chaos": out["chaos"]}))
    del eng, lm
    torch.cuda.empty_cache()
    return out


def resnet_server_phase(dev):
    """Phase 38: the batch Server over resnet50() in eval, f32,
    channels-last, phase 9's seeded weights: RS_REQUESTS single-image
    requests from RS_CLIENTS client threads at buckets RS_BUCKETS."""
    import threading
    from paddle1_tpu_torch.serving import InferenceEngine, Server
    from paddle1_tpu_torch.vision.models import resnet50
    model = resnet50(generator=torch.Generator().manual_seed(SEED))
    model.eval()
    eng = InferenceEngine(model, buckets=RS_BUCKETS,
                          input_specs=[((3, RN_IMG, RN_IMG), "float32")])
    check(eng.warm_up() == len(RS_BUCKETS), "warm-up missed a bucket")
    rng = np.random.default_rng(SEED + 380)
    images = [rng.standard_normal((1, 3, RN_IMG, RN_IMG)).astype(np.float32)
              for _ in range(RS_REQUESTS)]
    srv = Server(eng, max_batch=RS_MAX_BATCH, batch_timeout_ms=RS_TIMEOUT_MS,
                 queue_depth=RS_REQUESTS + RS_MAX_BATCH).start()
    counters = bn_counters()
    zero(counters)
    futs, lat = [None] * RS_REQUESTS, [0.0] * RS_REQUESTS

    def client(c):
        mine = range(c, RS_REQUESTS, RS_CLIENTS)
        t = {}
        for i in mine:
            t[i] = time.perf_counter()
            futs[i] = srv.submit(images[i])
        for i in mine:
            futs[i].result(timeout=300)
            lat[i] = (time.perf_counter() - t[i]) * 1e3
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(RS_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    rep = srv.drain(timeout=300)
    torch.cuda.synchronize()
    launches = bn_launches(counters)
    snap = srv.metrics.snapshot()
    check(rep["fatal"] is None and rep["unaccounted"] == 0 and
          rep["completed"] == RS_REQUESTS, f"server drain report {rep}")
    check(launches["fused_bn_norm"] == RN_BNS * rep["batches"] and
          launches["fused_bn_train"] == 0, f"launches {launches}, want "
          f"{RN_BNS} fused_bn_norm per batch x {rep['batches']}")
    dispatches = dict(eng.dispatch_counts)
    outs = [f.result() for f in futs]
    # each output against its row of the same padded bucket's direct
    # forward (bit for bit), then against its own bucket-1 forward
    batches = {}
    for i, f in enumerate(futs):
        batches.setdefault(id(f._batch), []).append((f._lo, i))
    with torch.inference_mode():
        for rows in batches.values():
            rows.sort()
            x = np.concatenate([images[i] for _, i in rows])
            padded, n, bucket = eng.pad_to_bucket([x])
            direct = model(torch.from_numpy(padded[0]).to(dev)).cpu().numpy()
            for lo, i in rows:
                check(np.array_equal(outs[i], direct[lo:lo + 1]),
                      f"request {i}: differs from row {lo} of its bucket-"
                      f"{bucket} forward")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    seq = [eng.infer([im])[0] for im in images]
    seq_wall = time.perf_counter() - t1
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs, seq))
    check(err <= RS_TOL, f"batched outputs differ from bucket-1 forwards by "
          f"{err} > {RS_TOL}")
    check(all(np.isfinite(o).all() for o in outs), "non-finite logits")
    # one full bucket's forward: host-clock ms against the device's busy
    x32 = torch.from_numpy(np.concatenate(images[:RS_MAX_BATCH])).to(dev)

    def forward():
        with torch.inference_mode():
            return model(x32).sum()
    forward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(4):
        forward()
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t2) * 1e3 / 4
    busy = device_kernels_per_step(forward, 2, top=6)[
        "device_busy_ms_per_step"]
    sizes = snap["histograms"]["batch_occupancy"]
    summary = {
        "model": "resnet50", "dtype": "float32", "layout": "channels_last",
        "requests": RS_REQUESTS, "clients": RS_CLIENTS,
        "buckets": list(RS_BUCKETS), "max_batch": RS_MAX_BATCH,
        "batch_timeout_ms": RS_TIMEOUT_MS, "batches": rep["batches"],
        "dispatch_counts": dispatches,
        "qps_batched": RS_REQUESTS / wall, "qps_sequential":
            RS_REQUESTS / seq_wall,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "batch_occupancy_mean": sizes["mean"],
        "max_abs_err_vs_bucket1": err, "bucket32_forward_ms": fwd_ms,
        "bucket32_device_busy_ms": busy,
        "bucket32_device_idle_share": 1.0 - busy / fwd_ms,
        "launches": launches,
        "launches_per_batch": launches["fused_bn_norm"] / rep["batches"],
        "unaccounted": rep["unaccounted"]}
    log(json.dumps({"resnet_server": summary}))
    del srv, eng, model
    torch.cuda.empty_cache()
    return summary



# ---------------------------------------------------------------------------
# phase 39: rows 8-12 in float16 (F24)

# ResNet-50's four shapes and YOLOv3's stem at 8 x 608² (phase 41's path)
YOLO_TRAIN_STEM = (2957312, 32)
BN_F16_SHAPES = BN_SHAPES + (YOLO_TRAIN_STEM,)


def f16_row_excess(got, want):
    """How far |got - want| exceeds one f16 rounding step of the value
    (``F16_REL``: each side rounds its own f32 result) plus BN_ABS."""
    got_f, want_f = got.float(), want.float()
    return float(((got_f - want_f).abs() - F16_REL * want_f.abs()).max()) \
        - BN_ABS


def bn_f16_check(dev, shapes=BN_F16_SHAPES):
    """Rows 8-12 on f16 rows over f16 and over f32 affine parameters
    against their plain versions (phase 39): ``{kernel: [case errors]}``,
    the moments under ``fused_bn_moments``."""
    from paddle1_tpu_torch.core.errors import InvalidArgumentError
    from paddle1_tpu_torch.ops import fused_bn as fbn
    from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
    errs = {k: [] for k in list(bn_counters()) + ["fused_bn_moments"]}
    eps = 1e-5
    for rows, c in shapes:
        (x, g16, b16, res, m, v, dy), = bn_inputs(
            dev, rows, c, torch.float16, SEED + 39 + rows + c)
        for pdtype in (torch.float16, torch.float32):
            g, b = g16.to(pdtype), b16.to(pdtype)
            for act, use_res in (("identity", False), ("relu", True)):
                r = res if use_res else None
                tag = (f"f16 [{rows}, {c}] params {str(pdtype)[6:]} "
                       f"act={act} res={use_res}")
                y, mean, var = fbn._train_fwd(x, g, b, r, eps, act)
                ry, rm, rv = fbn.fused_bn_train_ref(x, g, b, eps, act, r)
                tb = fbb.train_bwd(x, g, mean, var, y, dy, eps, act,
                                   use_res)
                rtb = fbb.train_bwd_ref(x, g, mean, var, y, dy, eps, act,
                                        use_res)
                yn = fbn._norm_fwd(x, m, v, g, b, r, eps, act)
                ryn = fbn.fused_bn_norm_ref(x, m, v, g, b, eps, act, r)
                nb = fbb.norm_bwd(x, g, m, v, yn, dy, eps, act, use_res)
                rnb = fbb.norm_bwd_ref(x, g, m, v, yn, dy, eps, act,
                                       use_res)
                torch.cuda.synchronize()
                checks = {
                    "fused_bn_train": ([(y, ry)], [(mean, rm), (var, rv)]),
                    "fused_bn_norm": ([(yn, ryn)], []),
                    "fused_bn_train_bwd": (
                        [(tb[0], rtb[0])] + ([(tb[3], rtb[3])]
                                             if use_res else []),
                        [(tb[1], rtb[1]), (tb[2], rtb[2])]),
                    "fused_bn_norm_bwd": (
                        [(nb[0], rnb[0])] + ([(nb[3], rnb[3])]
                                             if use_res else []),
                        [(nb[1], rnb[1]), (nb[2], rnb[2])])}
                for name, (row_pairs, stat_pairs) in checks.items():
                    for a, w in row_pairs:
                        check(a.dtype == torch.float16 and
                              bool(torch.isfinite(a).all()),
                              f"{name} {tag}: non-finite output or dtype "
                              f"{a.dtype}")
                    exc = max(f16_row_excess(a, w) for a, w in row_pairs)
                    check(exc <= 0.0, f"{name} {tag}: rows differ from the "
                          f"plain version by {exc} beyond the tolerance")
                    for a, w in stat_pairs:
                        sx = stat_excess(a, w, rows)
                        check(sx <= 0.0, f"{name} {tag}: statistics differ "
                              f"by {sx} beyond the tolerance")
                    errs[name].append({
                        "shape": [rows, c], "dtype": "float16",
                        "param_dtype": str(pdtype)[6:], "act": act,
                        "residual": use_res,
                        "max_abs_err": max(
                            float((a.float() - w.float()).abs().max())
                            for a, w in row_pairs + stat_pairs)})
                again = fbn._train_fwd(x, g, b, r, eps, act)
                check(all(torch.equal(a, w) for a, w in
                          zip(again, (y, mean, var))),
                      f"fused_bn_train {tag}: a repeat differs")
                again = fbb.train_bwd(x, g, mean, var, y, dy, eps, act,
                                      use_res)
                check(all(torch.equal(a, w) for a, w in zip(again, tb)),
                      f"fused_bn_train_bwd {tag}: a repeat differs")
                del y, tb, yn, nb, ry, rtb, ryn, rnb, again
        s, ss = fbn._moments_fwd(x)
        rs, rss = fbn.local_moments_ref(x)
        torch.cuda.synchronize()
        for a, w in ((s, rs), (ss, rss)):
            check(a.dtype == torch.float32, "local_moments f16: sums are "
                  f"{a.dtype}")
            sx = stat_excess(a, w, rows)
            check(sx <= 0.0, f"local_moments f16 [{rows}, {c}]: sums differ "
                  f"by {sx} beyond the tolerance")
        again = fbn._moments_fwd(x)
        check(torch.equal(again[0], s) and torch.equal(again[1], ss),
              f"local_moments f16 [{rows}, {c}]: a repeat differs")
        errs["fused_bn_moments"].append({
            "shape": [rows, c], "dtype": "float16",
            "max_abs_err": max(float((a - w).abs().max())
                               for a, w in ((s, rs), (ss, rss)))})
        log(f"batch norm kernels f16 [{rows}, {c}]: over f16 and f32 "
            "params, identity and relu + residual, within one f16 step "
            "of their plain versions, repeats bit-identical")
        del x, g16, b16, res, m, v, dy, s, ss, rs, rss
        torch.cuda.empty_cache()
    x = torch.zeros(64, 16, dtype=torch.float64, device=dev)
    ones = torch.ones(16, device=dev)
    for call in (lambda: fbn.fused_bn_train(x, ones, ones, 1e-5),
                 lambda: fbn.local_moments(x)):
        try:
            call()
            check(False, "a float64 batch norm did not raise")
        except InvalidArgumentError:
            pass
    return errs


def moments_timing(dev, shapes, images, dtype):
    """The moments kernel timed (graph replay over 4 input sets) beside
    its plain version, ``torch.batch_norm_stats`` on the same rows as
    channels-last [N, C, H, W] (``images`` square images; its mean and
    invstd checked against the kernel's sums) and its bound: one read of
    x, two f32 [C] written, 3 flops an element at the f32 rate."""
    from paddle1_tpu_torch.ops import fused_bn as fbn
    out = []
    itemsize = torch.empty((), dtype=dtype).element_size()
    dname = {torch.bfloat16: "bf16", torch.float32: "f32",
             torch.float16: "f16"}[dtype]
    eps = 1e-5
    for rows, c in shapes:
        xs = [t[0] for t in bn_inputs(dev, rows, c, dtype, SEED + 12,
                                      n_sets=4)]
        side = int(round((rows // images) ** 0.5))
        check(side * side * images == rows, f"{rows} rows are not "
              f"{images} square images")
        lib = [x.view(images, side, side, c).permute(0, 3, 1, 2)
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
        need = rows * c * itemsize + 2 * c * 4
        b_ms, by = bound(need, 3.0 * rows * c, F32_FLOPS_PER_S)
        out.append({"shape": [rows, c], "dtype": dname, **t,
                    "library_covers": "torch.batch_norm_stats (mean, "
                                      "invstd) on channels-last NCHW",
                    "bound_ms": b_ms, "bound_by": by, "bound_bytes": need})
        log(f"local_moments {dname} [{rows}, {c}]: kernel "
            f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
            f"torch.batch_norm_stats {t['library_ms']:.5f} ms, bound "
            f"{b_ms:.5f} ms ({by})")
        del xs, lib
        torch.cuda.empty_cache()
    return out


def bn_f16_phase(dev):
    """Phase 39 (the module docstring): the f16 checks, then the f16
    times at ResNet-50's shapes (32 images) and YOLOv3's stem (8)."""
    t0 = time.perf_counter()
    errs = bn_f16_check(dev)
    times = bn_timing(dev, BN_SHAPES, RN_BATCH, torch.float16)
    stem = bn_timing(dev, (YOLO_TRAIN_STEM,), YT_BATCH, torch.float16)
    for k in times:
        times[k] += stem[k]
    times["fused_bn_moments"] = moments_timing(
        dev, BN_SHAPES, RN_BATCH, torch.float16) + moments_timing(
        dev, (YOLO_TRAIN_STEM,), YT_BATCH, torch.float16)
    log(json.dumps({"bn_f16": {"seconds": time.perf_counter() - t0,
                               "cases": sum(len(v) for v in errs.values())}}))
    return errs, times


# ---------------------------------------------------------------------------
# phase 40: ResNet-50 in float16

# the f16 kernel path against the f16 plain path at phase 9's depth cut,
# three steps from identical weights, both held to the f32 plain path of
# the same steps. The two f16 paths round the activations at other places
# (the kernels once per batch norm at the edge, the plain composition
# after each of its ops, about 2^-11 relative each), ReLU inputs rounded
# to f16 land on the other side of the kink far more often than in f32,
# and the batch-norm biases' gradients cancel to a fraction of their
# terms: a bias's f16 update differs between the two paths by up to 16 %
# of its norm (CPU rehearsal at 16 x 64²). So, as phase 10's full-depth
# f32 check does against float64: the first losses within RN_F16_LOSS_REL
# of each other (relative), and the kernel path's updates no farther from
# the f32 path's than RN_F64_FACTOR times the f16 plain path's (the worst
# parameter and the median, each the L2 norm of the difference over the
# f32 update's, that denominator at least 1e-2 of the largest), the same
# of the running statistics
RN_F16_LOSS_REL = 1e-2


def resnet_f16_reference_check(dev):
    """The f16 kernel path against the f16 plain path (``fused_bn`` and
    ``fused_bn_bwd`` never) at phase 9's depth cut (one bottleneck a
    stage, 32 x 64²), REF_STEPS steps from identical weights, both held to
    the f32 plain path (RN_F16_LOSS_REL's note)."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.vision.models import resnet50
    model = resnet50(device=dev,
                     generator=torch.Generator().manual_seed(SEED + 40))
    for i in range(1, 5):
        setattr(model, f"layer{i}",
                getattr(model, f"layer{i}")[:RN_REF_CUT["blocks"]])
    plain, f32 = copy.deepcopy(model), copy.deepcopy(model)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 40)
    b, img = RN_REF_CUT["batch"], RN_REF_CUT["img"]
    data = {"x": torch.from_numpy(rng.standard_normal(
                (b, 3, img, img)).astype(np.float32)).to(dev),
            "y": torch.from_numpy(rng.integers(0, 1000, (b,))).to(dev)}
    counters = bn_counters()
    zero(counters)
    lk = rn_engine_steps(model, data, REF_STEPS, amp="float16")
    launches = bn_launches(counters)
    with flags_guard(fused_bn="never", fused_bn_bwd="never"):
        lp = rn_engine_steps(plain, data, REF_STEPS, amp="float16")
        l32 = rn_engine_steps(f32, data, REF_STEPS)
    check(bn_launches(counters) == launches, "the plain paths launched "
          "batch-norm kernels")
    want = {"fused_bn_train": 17 * REF_STEPS, "fused_bn_norm": 0,
            "fused_bn_train_bwd": 17 * REF_STEPS, "fused_bn_norm_bwd": 0}
    check(launches == want, f"f16 depth cut: kernel launches {launches}, "
          f"want {want}")
    sk, sp, s32 = (m.state_dict() for m in (model, plain, f32))
    stats = [k for k in sk if k.endswith(("_mean", "_variance"))]
    params = [k for k in sk if k not in stats]

    def gaps(a, ref):
        """Per key ``|a_k - ref_k| / max(|ref_k|, 1e-2 max |ref|)``, L2
        norms: the worst (and its key) and the median."""
        top = max(float(ref[k].double().norm()) for k in ref)
        rel = {k: float((a[k].double() - ref[k].double()).norm()) /
               max(float(ref[k].double().norm()), 1e-2 * top) for k in ref}
        worst = max(rel, key=rel.get)
        return {"max": rel[worst], "key": worst,
                "median": float(np.median(list(rel.values())))}
    upd = {n: {k: st[k] - init[k] for k in params}
           for n, st in (("kernel", sk), ("plain", sp), ("f32", s32))}
    st = {n: {k: d[k] for k in stats}
          for n, d in (("kernel", sk), ("plain", sp), ("f32", s32))}
    readings = {
        "update_kernel_vs_f32": gaps(upd["kernel"], upd["f32"]),
        "update_plain_vs_f32": gaps(upd["plain"], upd["f32"]),
        "update_kernel_vs_plain": gaps(upd["kernel"], upd["plain"]),
        "stat_kernel_vs_f32": gaps(st["kernel"], st["f32"]),
        "stat_plain_vs_f32": gaps(st["plain"], st["f32"])}
    loss_rel = abs(lk[0] - lp[0]) / abs(lp[0])
    out = {"losses_kernel": lk, "losses_plain": lp, "losses_f32": l32,
           "first_loss_rel_err": loss_rel, **readings,
           "tolerances": {"first_loss_rel": RN_F16_LOSS_REL,
                          "factor_over_plain": RN_F64_FACTOR}}
    log(json.dumps({"resnet_f16_reference": out}))
    check(all(np.isfinite(lk + lp)), f"non-finite f16 losses {lk} {lp}")
    check(loss_rel <= RN_F16_LOSS_REL, f"f16 depth cut: first losses {lk[0]} "
          f"vs {lp[0]}")
    for what in ("update", "stat"):
        k, p = readings[f"{what}_kernel_vs_f32"], \
            readings[f"{what}_plain_vs_f32"]
        for stat in ("max", "median"):
            check(k[stat] <= RN_F64_FACTOR * p[stat], f"f16 depth cut: the "
                  f"kernel path's {what}s are {k[stat]} ({stat}) from the "
                  f"f32 path's, the plain path's {p[stat]}")
    del model, plain, f32
    torch.cuda.empty_cache()
    return out


def resnet_f16_phase(dev):
    """Phase 40 (the module docstring)."""
    import copy
    from paddle1_tpu_torch import distributed as pdist
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet50
    t0 = time.perf_counter()
    model = resnet50(generator=torch.Generator().manual_seed(SEED))
    eng = pdist.ParallelEngine(
        model, Momentum(learning_rate=RN_LR, momentum=0.9,
                        parameters=model.parameters()),
        rn_loss_fn, amp_dtype="float16")
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal(
                 (RN_BATCH, 3, RN_IMG, RN_IMG)).astype(np.float32)).to(dev),
             "y": torch.from_numpy(rng.integers(
                 0, 1000, (RN_BATCH,)).astype(np.int64)).to(dev)}
    counters = bn_counters()
    zero(counters)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(eng.step(batch)) for _ in range(3)]
    train = bn_launches(counters)
    want = {"fused_bn_train": 3 * RN_BNS, "fused_bn_norm": 0,
            "fused_bn_train_bwd": 3 * RN_BNS, "fused_bn_norm_bwd": 0}
    check(train == want, f"f16 training launches {train}, want {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"f16 ResNet-50 losses not finite and falling: {losses}")
    slopes, _, steps = timed_steps(lambda: eng.step(batch), 8)
    dt = float(np.median(slopes))
    peak = torch.cuda.max_memory_allocated() / 1e9
    device = device_kernels_per_step(lambda: eng.step(batch), 2)
    del eng
    # an f16 copy in eval: every batch norm on row 9 in f16, its running
    # statistics calibrated on the batch first (momentum 0, one training
    # forward under no_grad): the init's mean 0 and variance 1 let the
    # activations grow past f16's range over 53 batch norms
    m16 = copy.deepcopy(model).to(dtype=torch.float16)
    for bn in m16.modules():
        if hasattr(bn, "_momentum"):
            bn._momentum = 0.0
    with torch.no_grad():
        m16(batch["x"].half())
    m16.eval()
    zero(counters)
    with torch.no_grad():
        logits = m16(batch["x"].half())
    torch.cuda.synchronize()
    evals = bn_launches(counters)
    want = {"fused_bn_train": 0, "fused_bn_norm": RN_BNS,
            "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": 0}
    check(evals == want, f"f16 eval launches {evals}, want {want}")
    check(logits.dtype == torch.float16 and
          bool(torch.isfinite(logits).all()), "f16 eval logits not finite")
    del m16, logits
    # rows 10 and 12 in f16: two steps on a one-rank mesh over NCCL
    pdist.init_parallel_env()
    try:
        dpc = dp_counters()
        model_dp = resnet50(generator=torch.Generator().manual_seed(SEED))
        eng = pdist.ParallelEngine(
            model_dp, Momentum(learning_rate=RN_LR, momentum=0.9,
                               parameters=model_dp.parameters()),
            rn_loss_fn, mesh=pdist.build_mesh(dp=1), amp_dtype="float16")
        staged = eng.shard_batch(batch)
        zero(dpc)
        dp_losses = [float(eng.step(staged)) for _ in range(2)]
        torch.cuda.synchronize()
        dp_launches = bn_launches(dpc)
    finally:
        pdist.destroy_process_group()
    want = {"fused_bn_moments": 2 * RN_BNS, "fused_bn_train": 0,
            "fused_bn_norm": 2 * RN_BNS, "fused_bn_train_bwd": 0,
            "fused_bn_norm_bwd": 2 * RN_BNS}
    check(dp_launches == want, f"f16 dp launches {dp_launches}, want {want}")
    check(all(np.isfinite(dp_losses)), f"non-finite f16 dp loss {dp_losses}")
    del eng, model_dp, staged, model
    torch.cuda.empty_cache()
    ref = resnet_f16_reference_check(dev)
    summary = {
        "train": "resnet50", "amp": "float16", "batch": RN_BATCH,
        "img": RN_IMG, "losses": losses, "launches_train": train,
        "launches_per_step": {k: n / 3 for k, n in train.items()},
        "steps_timed": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3, "samples_per_s": RN_BATCH / dt,
        "device_busy_ms_per_step": device["device_busy_ms_per_step"],
        "idle_share": 1.0 - device["device_busy_ms_per_step"] / (dt * 1e3),
        "bn_ms_per_step": device["bn_ms_per_step"],
        "peak_mem_gb": peak, "launches_eval": evals,
        "dp_losses": dp_losses, "launches_dp": dp_launches,
        "reference": ref, "seconds": time.perf_counter() - t0}
    log(json.dumps({"resnet50_f16": summary}))
    return summary


# ---------------------------------------------------------------------------
# phase 41: YOLOv3 training (PaddleDetection's
# configs/yolov3/yolov3_darknet53_270e_coco.yml: yolov3 80 classes,
# ignore_thresh 0.7, Momentum(1e-3, 0.9, L2Decay(5e-4)), batch 8 at the
# largest 608² of its 320-608 multi-scale set); seeded synthetic images
# with 1-50 boxes each (no COCO in the repository)

YT_BATCH, YT_IMG, YT_STEPS, YT_MAX_BOXES = 8, 608, 12, 50
YT_LR, YT_MOMENTUM, YT_DECAY, YT_IGNORE = 1e-3, 0.9, 5e-4, 0.7
# the f32 kernel-vs-plain check: backbone cut to one DarkBlock a stage, at
# YOLO_REF_BATCH x 608², REF_STEPS steps, each from the plain path's state
YT_REF_CUT, YT_REF_TOL = (1, 1, 1, 1, 1), 1e-4


def yt_batches(dev, n, batch=YT_BATCH, img=YT_IMG, seed=SEED + 41):
    """``n`` seeded batches on the card: images N(0, 1), and 1-50 boxes an
    image over the 80 classes (centre-size, normalized; -1 labels and zero
    boxes pad to YT_MAX_BOXES), mixup scores 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        count = rng.integers(1, YT_MAX_BOXES + 1, batch)
        box = np.zeros((batch, YT_MAX_BOXES, 4), np.float32)
        lab = np.full((batch, YT_MAX_BOXES), -1, np.int32)
        for i, k in enumerate(count):
            box[i, :k, :2] = rng.uniform(0.05, 0.95, (k, 2))
            box[i, :k, 2:] = rng.uniform(0.02, 0.5, (k, 2))
            lab[i, :k] = rng.integers(0, YOLO_CLASSES, k)
        out.append({
            "x": torch.from_numpy(rng.standard_normal(
                (batch, 3, img, img)).astype(np.float32)).to(dev),
            "gt_box": torch.from_numpy(box).to(dev),
            "gt_label": torch.from_numpy(lab).to(dev),
            "gt_score": torch.ones(batch, YT_MAX_BOXES, device=dev)})
    return out


def yt_loss_fn(m, b):
    from paddle1_tpu_torch.vision.models import yolov3_loss
    return yolov3_loss(m(b["x"]), b["gt_box"], b["gt_label"],
                       num_classes=YOLO_CLASSES, ignore_thresh=YT_IGNORE,
                       downsample_ratios=(32, 16, 8),
                       gt_scores=b["gt_score"])


def yt_engine(model, amp="bfloat16"):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.regularizer import L2Decay
    opt = Momentum(learning_rate=YT_LR, momentum=YT_MOMENTUM,
                   parameters=model.parameters(),
                   weight_decay=L2Decay(YT_DECAY))
    return ParallelEngine(model, opt, yt_loss_fn, amp_dtype=amp), opt


def yolo_train_phase(dev):
    """Phase 41's training run (the module docstring)."""
    from paddle1_tpu_torch.vision.models import yolov3
    t0 = time.perf_counter()
    model = yolov3(num_classes=YOLO_CLASSES,
                   generator=torch.Generator().manual_seed(SEED + 41))
    check(sum(k.endswith("._mean") for k in model.state_dict()) == YOLO_BNS,
          "yolov3 does not have 72 batch norms")
    model.train()
    eng, _ = yt_engine(model)
    data = yt_batches(dev, 2)
    counters = bn_counters()
    torch.cuda.reset_peak_memory_stats()
    zero(counters)
    losses = [float(eng.step(data[i % 2])) for i in range(YT_STEPS)]
    launches = bn_launches(counters)
    want = {"fused_bn_train": YOLO_BNS * YT_STEPS, "fused_bn_norm": 0,
            "fused_bn_train_bwd": YOLO_BNS * YT_STEPS,
            "fused_bn_norm_bwd": 0}
    check(launches == want, f"YOLOv3 training launches {launches}, want "
          f"{want} ({YT_STEPS} steps)")
    check(all(np.isfinite(losses)), f"non-finite YOLOv3 loss {losses}")
    check(sum(losses[-2:]) < sum(losses[:2]), f"YOLOv3 loss did not fall "
          f"over {YT_STEPS} steps: {losses}")
    setup_s = time.perf_counter() - t0
    it = [0]

    def step():
        it[0] += 1
        return eng.step(data[it[0] % 2])
    slopes, _, steps = timed_steps(step, 8)
    dt = float(np.median(slopes))
    peak = torch.cuda.max_memory_allocated() / 1e9
    device = device_kernels_per_step(step, 2)
    busy = device["device_busy_ms_per_step"]
    summary = {
        "train": "yolov3", "amp": "bfloat16", "batch": YT_BATCH,
        "img": YT_IMG, "classes": YOLO_CLASSES,
        "boxes_per_image": [1, YT_MAX_BOXES], "batch_norms": YOLO_BNS,
        "params": sum(p.nelement() for p in model.parameters()),
        "losses": losses, "launches": launches,
        "launches_per_step": {k: n / YT_STEPS for k, n in launches.items()},
        "steps_timed": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3, "images_per_s": YT_BATCH / dt,
        "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / (dt * 1e3),
        "bn_ms_per_step": device["bn_ms_per_step"],
        "bn_share_of_busy": device["bn_ms_per_step"] / busy,
        "kernels_per_step": device["kernels_per_step"],
        "bn_kernels_per_step": device["bn_kernels_per_step"],
        "top_kernels": device["top_kernels"], "peak_mem_gb": peak,
        "setup_s": setup_s}
    log(json.dumps({"yolov3_train": summary}))
    del eng, model, data
    torch.cuda.empty_cache()
    return summary


def yolo_train_reference_check(dev):
    """Phase 41's f32 kernel path against the plain path (the module
    docstring): per step, the loss (relative), every parameter and running
    statistic (absolute and relative) within YT_REF_TOL, and every
    velocity as the L2 norm of its error over the plain path's (at least
    1e-2 of the largest) within YT_REF_TOL. Both paths take the leaky
    ReLUs' gradients on a float64 forward's pieces: on their own pieces
    (each f32 forward puts some of the 1e-5-close inputs on the other
    side) the first step's gradients part by up to 1 % of a weight's
    norm (CPU rehearsal), and on the plain f32 path's pieces by 9e-4."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.vision.models import DarkNet53, yolov3
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    gen = torch.Generator().manual_seed(SEED + 42)
    kernel = yolov3(num_classes=YOLO_CLASSES, generator=gen)
    kernel.backbone = DarkNet53(depths=YT_REF_CUT, generator=gen)
    kernel.train()
    acts = ActPieces(kernel)
    plain = copy.deepcopy(kernel)     # shares the hooks
    ek, ok_ = yt_engine(kernel, amp=None)
    ep, op_ = yt_engine(plain, amp=None)
    data = yt_batches(dev, REF_STEPS, batch=YOLO_REF_BATCH, seed=SEED + 43)
    counters = bn_counters()
    pk, pp = dict(kernel.named_parameters()), dict(plain.named_parameters())
    readings = []
    try:
        for i in range(REF_STEPS):
            # the kernel path starts each step from the plain path's state
            kernel.load_state_dict(plain.state_dict())
            for k, q in pp.items():
                ok_._slots_for(pk[k])["velocity"].copy_(
                    op_._slots_for(q)["velocity"])
            # the pieces: a float64 forward of the same state and batch
            exact = copy.deepcopy(plain).double()    # shares the hooks
            with flags_guard(fused_bn="never", fused_bn_bwd="never",
                             conv_nhwc="never"), torch.no_grad():
                acts.mode = "record"
                acts.restart()
                exact(data[i]["x"].double())
            del exact
            acts.mode = "replay"
            with flags_guard(fused_bn="never", fused_bn_bwd="never"):
                acts.restart()
                before = bn_launches(counters)
                lp = float(ep.step(data[i]))
                check(bn_launches(counters) == before, "the plain path "
                      "launched batch-norm kernels")
            flips_plain = acts.take()
            acts.restart()
            zero(counters)
            lk = float(ek.step(data[i]))
            launches = bn_launches(counters)
            flips = acts.take()
            acts.mode = None
            sk, sp = kernel.state_dict(), plain.state_dict()
            excess = {k: float(((sk[k].double() - sp[k].double()).abs() -
                                YT_REF_TOL * sp[k].double().abs()).max())
                      for k in sk}
            vk = {k: ok_._slots_for(pk[k])["velocity"] for k in pk}
            vp = {k: op_._slots_for(pp[k])["velocity"] for k in pp}
            top = max(float(v.norm()) for v in vp.values())
            vel = {k: float((vk[k] - vp[k]).norm()) /
                   max(float(vp[k].norm()), 1e-2 * top) for k in vp}
            wx, wv = max(excess, key=excess.get), max(vel, key=vel.get)
            readings.append({"loss_kernel": lk, "loss_plain": lp,
                             "loss_rel_err": abs(lk - lp) / abs(lp),
                             "state_excess": excess[wx], "worst_state": wx,
                             "velocity_rel_err": vel[wv],
                             "worst_velocity": wv,
                             "launches": launches, "flips": flips,
                             "flips_plain": flips_plain})
    finally:
        acts.remove()
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
    out = {"batch": YOLO_REF_BATCH, "img": YT_IMG, "depths": YT_REF_CUT,
           "batch_norms": sum(k.endswith("._mean")
                              for k in kernel.state_dict()),
           "tol": YT_REF_TOL, "steps": readings}
    log(json.dumps({"yolov3_train_reference": out}))
    n_bn = out["batch_norms"]
    for i, r in enumerate(readings):
        check(r["launches"]["fused_bn_train"] == n_bn and
              r["launches"]["fused_bn_train_bwd"] == n_bn,
              f"YOLOv3 reference step {i + 1}: launches {r['launches']}")
        check(np.isfinite(r["loss_kernel"]) and
              r["loss_rel_err"] <= YT_REF_TOL,
              f"YOLOv3 reference step {i + 1}: losses {r['loss_kernel']} "
              f"vs {r['loss_plain']}")
        check(r["state_excess"] <= YT_REF_TOL, f"YOLOv3 reference step "
              f"{i + 1}: a parameter or statistic differs by "
              f"{r['state_excess']} beyond {YT_REF_TOL}")
        check(r["velocity_rel_err"] <= YT_REF_TOL, f"YOLOv3 reference step "
              f"{i + 1}: velocities differ by {r['velocity_rel_err']}")
        far = max(r["flips"]["far"], r["flips_plain"]["far"])
        check(far <= 1e-3, f"YOLOv3 reference step {i + 1}: a leaky ReLU "
              f"input {far} from its kink changed side")
    del ek, ep, kernel, plain, data
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 42: VGG16-BN eval

VGG_BATCH, VGG_IMG, VGG_BNS, VGG_TOL, VGG_STEPS = 8, 224, 13, 1e-4, 8


def vgg_phase(dev):
    """Phase 42 (the module docstring): ``vgg16(batch_norm=True)`` with
    seeded weights, its batch norms' gamma and beta moved off 1 and 0 and
    their statistics calibrated on one seeded batch (momentum 0, one
    training-mode forward under no_grad), in eval; the kernel path's
    logits against the plain path's."""
    import copy
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.nn import BatchNorm2D
    from paddle1_tpu_torch.vision.models import vgg16
    model = vgg16(batch_norm=True,
                  generator=torch.Generator().manual_seed(SEED + 44))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2D)]
    check(len(bns) == VGG_BNS, f"vgg16_bn has {len(bns)} batch norms")
    # gamma and beta off their init (at 1 and 0 the kernel's fused
    # multiply-add and the plain path's two roundings agree bit for bit)
    gen = torch.Generator().manual_seed(SEED + 45)
    with torch.no_grad():
        for bn in bns:
            c = bn.weight.shape[0]
            bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
            bn._momentum = 0.0
    rng = np.random.default_rng(SEED + 44)
    calib, x = (torch.from_numpy(rng.standard_normal(
        (VGG_BATCH, 3, VGG_IMG, VGG_IMG)).astype(np.float32)).to(dev)
        for _ in range(2))
    with torch.no_grad():
        model(calib)
    model.eval()
    plain = copy.deepcopy(model)
    counters = bn_counters()
    zero(counters)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        with torch.no_grad():
            logits = model(x)
            torch.cuda.synchronize()
            launches = bn_launches(counters)
            with flags_guard(fused_bn="never"):
                want = plain(x)
            torch.cuda.synchronize()
            plain_launches = bn_launches(counters)
            # the warm eval forward, by the slope protocol (the first
            # forward above paid cuDNN's plans and the kernel's build)
            slopes, _, _ = timed_steps(lambda: model(x)[0, 0], VGG_STEPS)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
    check(launches == {"fused_bn_train": 0, "fused_bn_norm": VGG_BNS,
                       "fused_bn_train_bwd": 0, "fused_bn_norm_bwd": 0},
          f"VGG16-BN eval launches {launches}")
    check(plain_launches == launches,
          f"VGG16-BN plain path launched batch-norm kernels: "
          f"{plain_launches} after {launches}")
    ms = float(np.median(slopes)) * 1e3
    err = float((logits - want).abs().max() / want.abs().max())
    out = {"eval": "vgg16_bn", "batch": VGG_BATCH, "img": VGG_IMG,
           "dtype": "float32", "launches": launches, "forward_ms": ms,
           "forward_ms_slopes": [t * 1e3 for t in slopes],
           "logit_err_over_max_abs": err, "tol": VGG_TOL}
    log(json.dumps({"vgg16_bn_eval": out}))
    check(tuple(logits.shape) == (VGG_BATCH, 1000) and
          bool(torch.isfinite(logits).all()), "VGG16-BN logits not finite")
    check(err <= VGG_TOL, f"VGG16-BN: kernel path against plain path {err}")
    del model, plain, logits, want
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 43-45: slice 4b(i)-(ii): the collectives on NCCL, config 4
# through fleet, and the sharded and model-parallel engine across ranks

# the all-reduce sweep's payloads (MB of f32 a rank) and timed calls
BUSBW_MB, BUSBW_REPS = (1, 4, 16, 64, 256), 20
# phase 45: ERNIE-1.5B at full width cut to HY_DEPTH layers, f32, the
# global batch HY_BATCH x ERNIE_SEQ, REF_STEPS AdamW steps at config 4's
# lr on each mesh against the world-size-1 engine on the whole batch. The
# losses within REF_TOL; the first step's gradient (every shard gathered)
# within HY_GRAD_TOL of world size 1's, each leaf's gap over its norm (a
# wrong scale, sign or shard shows there: Adam's update hardly sees the
# gradient's scale); the parameters after the steps within HY_MOVE_TOL,
# each leaf's gap over its own movement at world size 1, ||p - p_ref|| /
# ||p_ref - p_0|| (Adam turns the f32 rounding of a gradient element near
# zero into a step of about lr, so an absolute limit below REF_STEPS x lr
# cannot tell a sound run from one that moves a shard wrongly). A leaf
# whose reference gradient is zero to rounding (its RMS below HY_ZERO_GRAD
# of the whole gradient's: the attention key biases, which the softmax
# cannot see) is held apart, its gap within 2 x REF_STEPS x lr only. The
# limits sit between the readings of sound runs and of planted faults
# (hy_plant) on one H100: sound, gradient 5.8e-6 and movement 1.8e-4 at
# most; planted, 0.030 and 0.086 at least (PERF.md, PR 26).
HY_DEPTH, HY_BATCH, HY_RANKS, HY_TIMEOUT_S = 2, 4, 2, 600
HY_LR, HY_GRAD_TOL, HY_MOVE_TOL, HY_ZERO_GRAD = ERNIE_LR, 1e-3, 5e-3, 1e-4
HY_MESHES = (("sharding2_zero2", {"sharding": 2}, {"zero_stage": 2}),
             ("sharding2_zero3", {"sharding": 2}, {"zero_stage": 3}),
             ("mp2", {"mp": 2}, {}))
# planted faults (tools/torch_hybrid_phases.py --plant) and the mesh each
# is planted in: phase 45's check must fail every one
HY_PLANTS = {"zero_shard": "sharding2_zero2",
             "unaveraged": "sharding2_zero2", "drop_f": "mp2"}


class CollectiveCount:
    """Counts the ``torch.distributed`` collectives the port calls inside
    the block, by kind: all-reduce, reduce-scatter, all-gather (into one
    tensor or a list), broadcast and the one-tensor all-to-all (the
    pipeline's and the sequence ring's shifts, Ulysses' exchanges)."""

    KINDS = {"all_reduce": "all_reduce",
             "reduce_scatter_tensor": "reduce_scatter",
             "reduce_scatter_single": "reduce_scatter",
             "all_gather_into_tensor": "all_gather",
             "all_gather_single": "all_gather",
             "all_gather": "all_gather", "broadcast": "broadcast",
             "all_to_all_single": "all_to_all"}

    def __enter__(self):
        import torch.distributed as tdist
        self._orig = {k: getattr(tdist, k) for k in self.KINDS
                      if hasattr(tdist, k)}
        self.n = {k: 0 for k in set(self.KINDS.values())}
        for name, fn in self._orig.items():
            def counted(*a, _fn=fn, _kind=self.KINDS[name], **kw):
                self.n[_kind] += 1
                return _fn(*a, **kw)
            setattr(tdist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist
        for name, fn in self._orig.items():
            setattr(tdist, name, fn)
        return False


def collective_checks(dev):
    """Every collective of the port on card tensors of this rank, each
    against its value computed on the host: rank r holds ``arange(8) +
    10 r``. Point-to-point runs where there is a peer. Returns the names
    checked."""
    from paddle1_tpu_torch import distributed as pdist
    from paddle1_tpu_torch.distributed import collective as C
    r, n = pdist.get_rank(), pdist.get_world_size()
    base = [torch.arange(8, dtype=torch.float32) + 10.0 * j
            for j in range(n)]
    mine = base[r].to(dev)
    total = torch.stack(base).sum(0)
    done = []

    def same(got, want, name):
        check(got.device.type == "cuda", f"{name}: result left the card")
        check(torch.equal(got.cpu(), want.cpu()),
              f"{name}: {got.cpu().tolist()} != {want.cpu().tolist()}")
        done.append(name)
    for op, want in (("SUM", total), ("MAX", base[-1]), ("MIN", base[0])):
        same(pdist.all_reduce(mine.clone(), getattr(pdist.ReduceOp, op)),
             want, f"all_reduce_{op}")
    same(pdist.broadcast(mine.clone(), src=n - 1), base[-1], "broadcast")
    same(pdist.all_gather(None, mine), torch.stack(base), "all_gather")
    objs = []
    pdist.all_gather_object(objs, r)
    check(objs == list(range(n)), f"all_gather_object gave {objs}")
    done.append("all_gather_object")
    full = torch.arange(2 * n, dtype=torch.float32, device=dev) + r
    want = (torch.arange(2 * n, dtype=torch.float32) * n +
            sum(range(n)))[2 * r:2 * r + 2]
    same(pdist.reduce_scatter(torch.zeros(2, device=dev), full), want,
         "reduce_scatter")
    same(C.all_gather_into(torch.zeros(2 * n, device=dev),
                           torch.full((2,), float(r), device=dev)),
         torch.arange(n, dtype=torch.float32).repeat_interleave(2),
         "all_gather_into")
    parts = [b.to(dev) + 100 for b in base] if r == 0 else None
    same(pdist.scatter(torch.zeros(8, device=dev), parts, src=0),
         base[r] + 100, "scatter")
    same(pdist.alltoall([mine + j for j in range(n)]),
         torch.stack([b + r for b in base]), "alltoall")
    world = pdist.get_group()
    x = mine.clone().requires_grad_()
    (C._c_identity(x, world) * (r + 1)).sum().backward()
    same(x.grad, torch.full((8,), n * (n + 1) / 2), "c_identity")
    x = mine.clone().requires_grad_()
    y = C._mp_allreduce(x, world)
    (y * (r + 1)).sum().backward()
    same(y.detach(), total if n > 1 else base[r], "mp_allreduce")
    same(x.grad, torch.full((8,), r + 1.0), "mp_allreduce_grad")
    if n > 1:
        # a ring: even ranks send first, odd ranks receive first (NCCL
        # sets up a pair's communicator at its first transfer, and a ring
        # of sends alone would wait on itself)
        nxt, prv = (r + 1) % n, (r - 1) % n
        buf = torch.zeros(8, device=dev)
        if r % 2:
            work = [pdist.irecv(buf, src=prv), pdist.isend(mine, dst=nxt)]
        else:
            work = [pdist.isend(mine, dst=nxt), pdist.irecv(buf, src=prv)]
        for w in work:
            w.wait()
        same(buf, base[prv], "isend_irecv")
    return done


def busbw_sweep(dev):
    """``benches.py``'s all-reduce bus-bandwidth sweep (nccl-tests
    conventions: algbw = a rank's payload / time, busbw = algbw x 2(n-1)/n,
    the ring's wire traffic) over the world group, each payload's calls
    timed between CUDA events, in place, SUM, f32."""
    from paddle1_tpu_torch import distributed as pdist
    n = pdist.get_world_size()
    out = []
    for mb in BUSBW_MB:
        x = torch.ones(mb * (1 << 20) // 4, dtype=torch.float32, device=dev)
        for _ in range(3):
            pdist.all_reduce(x)
        torch.cuda.synchronize()
        pdist.barrier()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(BUSBW_REPS):
            pdist.all_reduce(x)
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / BUSBW_REPS
        algbw = x.nelement() * 4 / dt
        out.append({"payload_mb": mb, "time_us": dt * 1e6,
                    "algbw_gbps": algbw / 1e9,
                    "busbw_gbps": algbw * 2 * (n - 1) / n / 1e9})
        del x
    return out


def nccl_rank_worker(out_dir, init_file):
    """One rank of phase 43 on its own card (``distributed.spawn``)."""
    import os
    from paddle1_tpu_torch import distributed as pdist
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    dev = torch.device("cuda", rank)
    pdist.init_parallel_env(device=dev, init_method=f"file://{init_file}")
    try:
        res = {"checked": collective_checks(dev), "sweep": busbw_sweep(dev),
               "backend": torch.distributed.get_backend()}
        torch.save(res, os.path.join(out_dir, f"nccl{rank}.pt"))
    finally:
        pdist.destroy_process_group()


def collectives_phase(dev):
    """Phase 43: every collective on NCCL over the visible cards, one rank
    a card (on one card: world size 1, point-to-point skipped), held to
    host arithmetic, and the all-reduce bus-bandwidth sweep, marked
    single-card where there is one."""
    import os
    import tempfile
    from paddle1_tpu_torch import distributed as pdist
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    if n == 1:
        pdist.init_parallel_env()
        try:
            backend = torch.distributed.get_backend()
            checked = collective_checks(dev)
            sweep = busbw_sweep(dev)
        finally:
            pdist.destroy_process_group()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            pdist.spawn(nccl_rank_worker, args=(tmp, os.path.join(
                tmp, "store")), nprocs=n, timeout=HY_TIMEOUT_S)
            got = torch.load(os.path.join(tmp, "nccl0.pt"))
        backend, checked, sweep = got["backend"], got["checked"], \
            got["sweep"]
    check(backend == "nccl", f"phase 43 ran {backend}")
    out = {"collectives_nccl": {
        "ranks": n, "backend": backend, "checked": checked,
        "point_to_point": "checked" if n > 1 else
        "skipped: one card, no peer",
        "allreduce_busbw": sweep,
        "blocked": "single-card: busbw is 0 by definition at one rank; "
                   "time_us is NCCL's one-rank all-reduce" if n == 1 else
                   None,
        "card": card_line(), "seconds": time.perf_counter() - t0}}
    log(json.dumps(out))
    return out["collectives_nccl"]


def ernie_fleet_phase(dev):
    """Phase 44: BASELINE config 4 through the user's entry points:
    ``fleet.init(is_collective=True, strategy)`` with ZeRO stage 2 and
    ``amp`` (bf16), ``apply_megatron_sharding``, then
    ``fleet.parallel_engine(ErnieForPretraining(ernie_1p5b()),
    AdamW(1e-4), loss_fn)`` at full width and depth over NCCL, one rank a
    visible card (here the world the smoke runs in), batch 4 x 512 a
    rank: timed by ``timed_steps``, the launch counts of phase 19, the
    loss finite and falling, peak memory, the optimizer slots held (1/n
    of the whole at sharding n) and the collectives a step."""
    from paddle1_tpu_torch import distributed as pdist
    from paddle1_tpu_torch.distributed import fleet, topology
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import (BertPretrainingCriterion,
                                               apply_megatron_sharding)
    t0 = time.perf_counter()
    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 2}
    strategy.amp = True
    fleet.init(is_collective=True, strategy=strategy)
    try:
        world = pdist.get_world_size()
        model = apply_megatron_sharding(ernie_model())
        n_params = sum(p.nelement() for p in model.parameters())
        eng = fleet.parallel_engine(
            model, AdamW(learning_rate=ERNIE_LR,
                         parameters=model.parameters()),
            ernie_loss_fn(BertPretrainingCriterion(ERNIE_VOCAB)))
        shards = eng.mesh.shape["sharding"]
        check(eng.zero_stage == 2 and eng.amp_dtype == torch.bfloat16 and
              shards == world and torch.distributed.get_backend() == "nccl",
              f"fleet compiled zero {eng.zero_stage}, amp {eng.amp_dtype}, "
              f"mesh {eng.mesh.shape} on {world} ranks")
        staged = eng.shard_batch(ernie_batch(ERNIE_BATCH * world,
                                             ERNIE_SEQ, seed=44))
        torch.cuda.reset_peak_memory_stats()
        loss0 = float(eng.step(staged))
        setup_s = time.perf_counter() - t0
        counters = train_counters()
        zero(counters)
        with CollectiveCount() as calls:
            slopes, last, steps = timed_steps(lambda: eng.step(staged), 8)
            torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        loss_end = float(last)
        check(np.isfinite(loss0) and np.isfinite(loss_end) and
              loss_end < loss0, f"ERNIE through fleet: loss {loss0} -> "
              f"{loss_end}")
        want = {"flash_attention": ERNIE_LAYERS * steps,
                "flash_attention_bwd_dkv": ERNIE_LAYERS * steps,
                "flash_attention_bwd_dq": ERNIE_LAYERS * steps,
                "fused_adam": steps,
                "layer_norm": (2 * ERNIE_LAYERS + 2) * steps}
        for k, v in want.items():
            check(launches[k] == v, f"ERNIE through fleet: {k} launched "
                  f"{launches[k]} times in {steps} steps, want {v}")
        peak = torch.cuda.max_memory_allocated()
        held = eng.slot_bytes()
        whole = 2 * 4 * n_params
        check(held * shards >= whole and
              held <= whole / shards + 2 * 4 * 64 * (len(eng.params) +
                                                       shards),
              f"ERNIE through fleet: {held} slot bytes at sharding "
              f"{shards}, the whole is {whole}")
    finally:
        pdist.destroy_process_group()
        topology.set_hybrid_communicate_group(None)
    dt = float(np.median(slopes))
    flops = (6 * n_params * ERNIE_BATCH * ERNIE_SEQ +
             12 * ERNIE_LAYERS * ERNIE_BATCH * ERNIE_SEQ ** 2 * ERNIE_HIDDEN)
    summary = {
        "train": "ernie_1p5b_pretraining_fleet", "card": card_line(),
        "ranks": world, "backend": "nccl", "mesh": eng.mesh.shape,
        "zero_stage": 2, "amp": "bfloat16", "batch_per_rank": ERNIE_BATCH,
        "seq_len": ERNIE_SEQ, "layers": ERNIE_LAYERS, "params": n_params,
        "setup_s": setup_s, "steps": steps, "timing": "slope+readback",
        "step_ms_median": dt * 1e3, "step_ms_min": min(slopes) * 1e3,
        "step_ms_max": max(slopes) * 1e3,
        "tokens_per_s_per_rank": ERNIE_BATCH * ERNIE_SEQ / dt,
        "mfu": flops / dt / BF16_FLOPS_PER_S,
        "loss_first": loss0, "loss_last": loss_end,
        "peak_mem_gb": peak / 1e9, "slot_bytes_held": held,
        "slot_bytes_whole": whole, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "collectives_per_step": {k: v / steps for k, v in calls.n.items()}}
    log(json.dumps({"ernie_fleet": summary}))
    del eng, model, staged
    torch.cuda.empty_cache()
    return summary


def hy_model(seed=SEED + 45):
    from paddle1_tpu_torch.text.models import apply_megatron_sharding
    return apply_megatron_sharding(ernie_model(depth=HY_DEPTH, seed=seed))


def hy_engine(model, **kw):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import BertPretrainingCriterion
    return ParallelEngine(model, AdamW(learning_rate=HY_LR,
                                       parameters=model.parameters()),
                          ernie_loss_fn(BertPretrainingCriterion(
                              ERNIE_VOCAB)), **kw)


def hy_plant(eng, fault):
    """Plant ``fault`` in an engine on a mesh, to show that phase 45's
    check fails it: ``zero_shard`` zeroes sharding rank 1's gradient shard
    after the reduce-scatter, ``unaveraged`` leaves the reduce-scatter's
    sum undivided by the data ranks, ``drop_f`` drops Megatron's f (the
    gradient's all-reduce over mp) from the first query projection."""
    from paddle1_tpu_torch.nn import functional as F
    if fault in ("zero_shard", "unaveraged"):
        reduce, z = eng._reduce_zero, eng._zero

        def planted(loss):
            out = reduce(loss)
            if fault == "unaveraged":
                z["gshard"].mul_(float(eng.mesh.data_group.nranks))
            elif z["group"].rank == 1:
                z["gshard"].zero_()
            return out
        eng._reduce_zero = planted
    elif fault == "drop_f":
        q = next(m for n, m in eng.model.named_modules()
                 if n.endswith("q_proj"))
        q.forward = lambda x: F.linear(x, q.weight, q.bias)
    else:
        raise ValueError(f"no planted fault {fault!r}")


@torch.no_grad()
def hy_gaps(state, grads, init, ref_state, ref_grads, lr):
    """Phase 45's readings of one run against world size 1, by leaf (the
    keys of ``ref_grads``): the first step's gradient gap over the
    reference gradient's norm, and the parameters' gap after the steps
    over their movement at world size 1, for every leaf whose reference
    gradient is not zero to rounding, with the largest absolute parameter
    gap (for the record); for those held apart the largest absolute
    parameter gap in units of lr."""
    rms = (sum(float(g.double().square().sum()) for g in ref_grads.values())
           / sum(g.nelement() for g in ref_grads.values())) ** 0.5
    grad_gap, move_gap, abs_gap, flat_gap = {}, {}, {}, {}
    for k, g in ref_grads.items():
        g, p = g.double(), state[k].double() - ref_state[k].double()
        if float(g.square().mean().sqrt()) < HY_ZERO_GRAD * rms:
            flat_gap[k] = float(p.abs().max()) / lr
            continue
        grad_gap[k] = float((grads[k].double() - g).norm() / g.norm())
        abs_gap[k] = float(p.abs().max())
        move_gap[k] = float(p.norm() / (ref_state[k].double() -
                                        init[k].double()).norm())
    return {"grad_gap": grad_gap, "move_gap": move_gap,
            "abs_param_gap": abs_gap, "flat_gap_in_lr": flat_gap}


def hybrid_rank_worker(out_dir, init_file, backend, one_card, runs):
    """One rank of phase 45 (``distributed.spawn``): each run of ``runs``
    (``(name, degrees, engine kwargs, planted fault or None)``) in turn,
    REF_STEPS f32 steps of the depth-cut ERNIE on the global batch, the
    first step's gradient gathered; rank 0 reads the gaps to world size 1
    (``hy_gaps``, the reference in ``out_dir``). Saves the losses, the
    gaps, the launches, the slots held, peak memory and the collectives a
    step."""
    import gc
    import os
    from paddle1_tpu_torch import distributed as pdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    dev = torch.device(CARD, 0 if one_card else rank)
    pdist.init_parallel_env(backend=backend, device=dev,
                            init_method=f"file://{init_file}")
    try:
        batch = ernie_batch(HY_BATCH, ERNIE_SEQ, seed=SEED + 45)
        ref = torch.load(os.path.join(out_dir, "ref.pt"), mmap=True) \
            if rank == 0 else None
        out = {"backend": torch.distributed.get_backend()}
        for name, degrees, kw, fault in runs:
            model = hy_model()
            eng = hy_engine(model, mesh=pdist.build_mesh(**degrees), **kw)
            if fault is not None:
                hy_plant(eng, fault)
            counters = train_counters()
            zero(counters)
            torch.cuda.reset_peak_memory_stats(dev)
            with CollectiveCount() as first:
                losses = [float(eng.step(batch))]
            peak = torch.cuda.max_memory_allocated(dev)
            grads = {k: v.cpu() for k, v in eng.full_grad_dict().items()}
            torch.cuda.reset_peak_memory_stats(dev)
            with CollectiveCount() as rest:
                for _ in range(REF_STEPS - 1):
                    losses.append(float(eng.step(batch)))
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
            launches = {k: fn.launches for k, fn in counters.items()}
            state = {k: v.cpu() for k, v in eng.full_state_dict().items()}
            out[name] = {
                "fault": fault, "losses": losses, "launches": launches,
                "slot_bytes": eng.slot_bytes(),
                "params_local": sum(p.nelement() for p in eng.params),
                "peak_mem_gb": peak / 1e9,
                "collectives_per_step": {
                    k: (first.n[k] + rest.n[k]) / REF_STEPS
                    for k in first.n},
                "gaps": (hy_gaps(state, grads, ref["init"], ref["state"],
                                 ref["grads"], HY_LR)
                         if rank == 0 else None)}
            del eng, model, state, grads
            gc.collect()           # a planted fault closes over its engine
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        pdist.destroy_process_group()


def hy_verdict(name, res, ref_losses):
    """What phase 45's accuracy check finds wrong in one run (the gaps of
    rank 0, the losses of every rank): a list of messages, empty when the
    run holds."""
    g = res[0]["gaps"]
    bad = []
    loss_err = max(abs(a - b) for r in res
                   for a, b in zip(r["losses"], ref_losses))
    if loss_err > REF_TOL:
        bad.append(f"{name}: losses {loss_err} from world size 1")
    for key, tol, what in (("grad_gap", HY_GRAD_TOL, "first-step gradient"),
                           ("move_gap", HY_MOVE_TOL, "parameter gap over "
                            "the movement"),
                           ("flat_gap_in_lr", 2 * REF_STEPS,
                            "gap (in lr) of a leaf without a gradient")):
        worst = max(g[key].items(), key=lambda kv: kv[1], default=(None, 0))
        if not worst[1] <= tol:        # NaN fails too
            bad.append(f"{name}: {what} {worst[1]} > {tol} at {worst[0]}")
    return bad


def hybrid_rank_check(dev, plants=()):
    """Phase 45: HY_RANKS ranks (gloo on one card, NCCL one a card where
    there are HY_RANKS cards) at ERNIE-1.5B's full width cut to HY_DEPTH
    layers, f32, on each of HY_MESHES — ZeRO stage 2 and stage 3 at
    sharding 2, tensor parallel at mp 2 — REF_STEPS steps against the
    world-size-1 engine on the whole batch (``hy_verdict``: the losses, the
    first step's gradient and the parameters' movement, the shards
    gathered), every rank launching rows 2-6 at its local shapes (flash at
    18 / mp heads, row 6 over its ZeRO shard), each rank's slots 1/2 of the
    whole at sharding 2. Each fault of ``plants`` (HY_PLANTS) then runs
    planted in its mesh, and the check must fail it. Every run's readings
    are logged before any check."""
    import os
    import tempfile
    from paddle1_tpu_torch import distributed as pdist
    t0 = time.perf_counter()
    model = hy_model()
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    eng = hy_engine(model)
    batch = ernie_batch(HY_BATCH, ERNIE_SEQ, seed=SEED + 45)
    ref_losses = [float(eng.step(batch))]
    ref_grads = {k: v.cpu() for k, v in eng.full_grad_dict().items()}
    ref_losses += [float(eng.step(batch)) for _ in range(REF_STEPS - 1)]
    ref = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    n_params = sum(p.nelement() for p in model.parameters())
    del eng, model
    torch.cuda.empty_cache()
    nccl = torch.cuda.device_count() >= HY_RANKS
    backend = "nccl" if nccl else "gloo"
    meshes = {name: (degrees, kw) for name, degrees, kw in HY_MESHES}
    runs = [(name, degrees, kw, None) for name, degrees, kw in HY_MESHES] + \
        [(f"{HY_PLANTS[f]}_planted_{f}", *meshes[HY_PLANTS[f]], f)
         for f in plants]
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"init": init, "state": ref, "grads": ref_grads},
                   os.path.join(tmp, "ref.pt"))
        del init
        pdist.spawn(hybrid_rank_worker, args=(
            tmp, os.path.join(tmp, "store"), backend, not nccl, runs),
            nprocs=HY_RANKS, timeout=HY_TIMEOUT_S)
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(HY_RANKS)]
    per_step = {"flash_attention": HY_DEPTH, "flash_attention_bwd_dkv":
                HY_DEPTH, "flash_attention_bwd_dq": HY_DEPTH,
                "fused_adam": 1, "layer_norm": 2 * HY_DEPTH + 2}
    whole = 2 * 4 * n_params
    out = {"card": card_line(), "ranks": HY_RANKS, "backend": backend,
           "one_card": not nccl, "depth": HY_DEPTH, "batch": HY_BATCH,
           "seq": ERNIE_SEQ, "dtype": "float32", "steps": REF_STEPS,
           "lr": HY_LR, "tol": {"loss": REF_TOL, "grad_gap": HY_GRAD_TOL,
                                "move_gap": HY_MOVE_TOL,
                                "flat_gap_in_lr": 2 * REF_STEPS,
                                "zero_grad_rms": HY_ZERO_GRAD},
           "losses_world_size_1": ref_losses, "slot_bytes_whole": whole}
    failures = [] if got[0]["backend"] == backend else \
        [f"phase 45 ran {got[0]['backend']}"]
    for name, degrees, kw, fault in runs:
        res = [g[name] for g in got]
        gaps = res[0]["gaps"]
        verdict = hy_verdict(name, res, ref_losses)

        def worst(key, k=4):
            return sorted(gaps[key].items(), key=lambda kv: -kv[1])[:k]
        out[name] = {
            "mesh": degrees, **kw, "fault": fault,
            "losses": [r["losses"] for r in res],
            "max_loss_err": max(abs(a - b) for r in res
                                for a, b in zip(r["losses"], ref_losses)),
            "max_grad_gap": worst("grad_gap", 1)[0][1],
            "max_move_gap": worst("move_gap", 1)[0][1],
            "max_abs_param_gap": worst("abs_param_gap", 1)[0][1],
            "worst_grad_gap": worst("grad_gap"),
            "worst_move_gap": worst("move_gap"),
            "flat_gap_in_lr": gaps["flat_gap_in_lr"],
            "verdict": verdict or "holds",
            "launches": [r["launches"] for r in res],
            "slot_bytes": [r["slot_bytes"] for r in res],
            "params_local": [r["params_local"] for r in res],
            "peak_mem_gb": [r["peak_mem_gb"] for r in res],
            "collectives_per_step": [r["collectives_per_step"]
                                     for r in res]}
        log(json.dumps({"hybrid_rank_check_" + name: out[name]}))
        if fault is not None:
            if not verdict:
                failures.append(f"{name}: the planted fault {fault} passed "
                                "the check")
            continue
        failures += verdict
        for r in res:
            for k, v in per_step.items():
                if r["launches"][k] != v * REF_STEPS:
                    failures.append(f"{name}: a rank launched {k} "
                                    f"{r['launches'][k]} times, want "
                                    f"{v * REF_STEPS}")
        shards = degrees.get("sharding", 1)
        if shards > 1 and not (
                sum(r["slot_bytes"] for r in res) == whole and
                all(r["slot_bytes"] <= whole / shards +
                    2 * 4 * 64 * (len(ref) + shards) for r in res)):
            failures.append(f"{name}: slots {[r['slot_bytes'] for r in res]}"
                            f" of {whole}")
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps({"hybrid_rank_check": {
        k: v for k, v in out.items() if k not in meshes and
        "_planted_" not in k}}))
    check(not failures, "; ".join(failures))
    return out



# ---------------------------------------------------------------------------
# phases 46-47: slice 4b(iii)-(iv): pipeline and sequence parallelism

# phase 46: config 4 through fleet at pp_degree PP_DEGREE: ERNIE-1.5B at
# full width and depth, bf16, pipeline_configs accumulate_steps PP_MICRO
# of micro_batch_size 1 on the batch ERNIE_BATCH x ERNIE_SEQ, PP_DEGREE
# ranks (gloo on one card; NCCL one a card where there are as many). Then
# the f32 cross-rank check at ERNIE's width cut to PP_DEPTH layers on each
# of PP_MESHES against world size 1, by phase 45's measures (hy_gaps,
# hy_verdict: the losses of every rank, the first step's gradient, the
# parameters' movement), and every rank's replicated tensors (embeddings
# and heads) within HY_MOVE_TOL of rank 0's, over their movement at world
# size 1 (pp_rep_gaps). Each fault of PP_PLANTS, planted in the pp2 mesh,
# must fail that check.
PP_DEGREE, PP_MICRO, PP_DEPTH, PP_TIMEOUT_S = 2, 4, 4, 600
PP_MESHES = (("pp2", {"pp": 2}, {"pp_microbatches": 4}),
             ("pp2_dp2", {"pp": 2, "dp": 2}, {"pp_microbatches": 2}))
# the gradient handed back across the cut zeroed; the micro-batches handed
# forward a tick late (the later stage runs micro-batch m on m - 1's
# activation); the input's gradient not broadcast from stage 0 (the later
# stages' replicated embeddings then miss the lookup's part)
PP_PLANTS = ("cut_grad", "handoff_order", "input_grad_bcast")
# phase 47: ring and Ulysses attention over SP_RANKS ranks at ERNIE's
# attention shape, the sequence cut to ERNIE_SEQ / SP_RANKS a rank, f32
# and bf16, causal and not, forward and backward of sum(out * w) against
# attention_ref over the whole sequence on one rank (f32, from the same
# rounded inputs): in f32 within SP_TOL (output) and SP_GRAD_TOL
# (gradients) abs, the CPU tests' limits; in bf16 each tensor's error norm
# within SP_BF16_REL of its norm (a bf16 rounding step is 2^-8 of a
# value). Each call timed SP_REPS times (host clock between barriers: the
# ranks share the card).
SP_RANKS, SP_REPS = 2, 5
SP_TOL, SP_GRAD_TOL, SP_BF16_REL = 2e-5, 5e-4, 2.0 ** -6


class PlantedHandoff:
    """``distributed.pipeline``'s collectives with one fault of PP_PLANTS,
    inside ``with PlantedHandoff(fault):`` (phase 46's check must fail
    each)."""

    def __init__(self, fault):
        from paddle1_tpu_torch.distributed import collective
        if fault not in PP_PLANTS:
            raise ValueError(f"no planted fault {fault!r}")
        self._real, self.fault, self._held = collective, fault, None

    def __enter__(self):
        from paddle1_tpu_torch.distributed import pipeline
        pipeline.collective = self
        return self

    def __exit__(self, *exc):
        from paddle1_tpu_torch.distributed import pipeline
        pipeline.collective = self._real
        return False

    def __getattr__(self, name):
        return getattr(self._real, name)

    def shift(self, send, recv, offset=1, group=None):
        out = self._real.shift(send, recv, offset, group)
        if recv is None or recv.nelement() == 0:
            return out
        if self.fault == "cut_grad" and offset == -1:
            recv.zero_()
        elif self.fault == "handoff_order" and offset == 1:
            late, self._held = self._held, recv.clone()
            if late is not None:
                recv.copy_(late)
        return out

    def broadcast_bytes(self, tensor, src=0, group=None):
        if self.fault == "input_grad_bcast" and src == 0:
            return tensor
        return self._real.broadcast_bytes(tensor, src, group)


def pp_model(depth=PP_DEPTH):
    return ernie_model(depth=depth, seed=SEED + 46)


def pp_replicated(key: str) -> bool:
    """A tensor every pp rank holds (not an encoder block's)."""
    return ".encoder.layers." not in key


@torch.no_grad()
def pp_rep_norms(state, dev):
    """||p_r - p_0|| of each replicated tensor of ``state`` (this rank's
    whole state) against global rank 0's, broadcast over the world (a
    collective call, every rank, in key order)."""
    from paddle1_tpu_torch import distributed as pdist
    out = {}
    for k in sorted(k for k in state if pp_replicated(k)):
        mine = state[k].to(dev).contiguous()
        r0 = pdist.broadcast(mine.clone(), 0)
        out[k] = float((mine.double() - r0.double()).norm())
    return out


def pp_rep_gaps(rank_norms, init, ref_state):
    """Each rank's largest replicated-tensor gap to rank 0 over the
    tensor's movement at world size 1 (``rank_norms``: one
    ``pp_rep_norms`` a rank)."""
    out = []
    for norms in rank_norms:
        worst = (None, 0.0)
        for k, v in norms.items():
            move = float((ref_state[k].double() - init[k].double()).norm())
            gap = v / max(move, 1e-30)
            if not gap <= worst[1]:
                worst = (k, gap)
        out.append(worst)
    return out


def ernie_pp_job(dev, out_dir):
    """Phase 46's run on this rank: ``fleet.init`` with ``pp_degree``
    PP_DEGREE, ``amp`` and ``pipeline_configs``, ``ErnieForPretraining(
    ernie_1p5b())`` through ``fleet.parallel_engine`` (this rank keeps
    its stage's blocks), the staged batch, one step, then
    ``timed_steps``: step ms, the loss, peak memory, the parameters held,
    the launches of rows 2-6 and the collectives a step."""
    from paddle1_tpu_torch.distributed import fleet, topology
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import BertPretrainingCriterion
    t0 = time.perf_counter()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": PP_DEGREE, "dp_degree": 1,
                               "mp_degree": 1}
    strategy.pipeline_configs = {"accumulate_steps": PP_MICRO,
                                 "micro_batch_size": 1}
    strategy.amp = True
    fleet.init(is_collective=True, strategy=strategy)
    try:
        model = ernie_model()
        n_whole = sum(p.nelement() for p in model.parameters())
        eng = fleet.parallel_engine(
            model, AdamW(learning_rate=ERNIE_LR,
                         parameters=model.parameters()),
            ernie_loss_fn(BertPretrainingCriterion(ERNIE_VOCAB)))
        del model
        torch.cuda.empty_cache()
        encs = [m for m in eng.model.modules()
                if getattr(m, "pipeline_group", None) is not None]
        setup = {"pp": eng.mesh.shape["pp"], "amp": str(eng.amp_dtype),
                 "micro": [m.pipeline_microbatches for m in encs]}
        staged = eng.shard_batch(ernie_batch(ERNIE_BATCH, ERNIE_SEQ,
                                             seed=46))
        torch.cuda.reset_peak_memory_stats(dev)
        loss0 = float(eng.step(staged))
        setup_s = time.perf_counter() - t0
        counters = train_counters()
        zero(counters)
        with CollectiveCount() as calls:
            slopes, last, steps = timed_steps(lambda: eng.step(staged), 8)
            torch.cuda.synchronize()
        return {"setup": setup, "setup_s": setup_s, "loss_first": loss0,
                "loss_last": float(last), "slopes": slopes, "steps": steps,
                "launches": {k: fn.launches for k, fn in counters.items()},
                "collectives": dict(calls.n),
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "params_local": sum(p.nelement() for p in eng.params),
                "params_whole": n_whole, "slot_bytes": eng.slot_bytes()}
    finally:
        topology.set_hybrid_communicate_group(None)


def pp_check_job(dev, out_dir, runs):
    """Phase 46's cross-rank check on this rank: each run of ``runs``
    (``(name, degrees, engine kwargs, planted fault or None)``), REF_STEPS
    f32 steps of the depth-cut ERNIE (``pp_model``) on the global batch,
    the first step's gradient and the state gathered; rank 0 reads the
    gaps to world size 1 (``hy_gaps``, the reference in ``out_dir``) and
    every rank's replicated-tensor gaps to it (``pp_rep_norms``)."""
    import contextlib
    import copy
    import gc
    import os
    from paddle1_tpu_torch import distributed as pdist
    rank = pdist.get_rank()
    batch = ernie_batch(HY_BATCH, ERNIE_SEQ, seed=SEED + 46)
    ref = None
    if rank == 0:       # the gaps are read on the card
        raw = torch.load(os.path.join(out_dir, "pp_ref.pt"), mmap=True)
        ref = {part: {k: v.to(dev) for k, v in raw[part].items()}
               for part in ("init", "state", "grads")}
        del raw
    out = {"backend": torch.distributed.get_backend()}
    first_model = pp_model()
    for name, degrees, kw, fault in runs:
        t = [time.perf_counter()]

        def lap():
            t.append(time.perf_counter())
            return t[-1] - t[-2]
        model = copy.deepcopy(first_model)
        eng = hy_engine(model, mesh=pdist.build_mesh(**degrees), **kw)
        del model
        secs = {"engine": lap()}
        counters = train_counters()
        zero(counters)
        torch.cuda.reset_peak_memory_stats(dev)
        plant = PlantedHandoff(fault) if fault is not None else \
            contextlib.nullcontext()
        with plant:
            with CollectiveCount() as first:
                losses = [float(eng.step(batch))]
            secs["first_step"] = lap()
            grads = eng.full_grad_dict()
            secs["grads"] = lap()
            with CollectiveCount() as rest:
                for _ in range(REF_STEPS - 1):
                    losses.append(float(eng.step(batch)))
            secs["steps"] = lap()
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: fn.launches for k, fn in counters.items()}
        state = eng.full_state_dict()
        secs["state"] = lap()
        norms = pp_rep_norms(state, dev)
        every = []
        pdist.all_gather_object(every, norms)
        secs["rep_norms"] = lap()
        out[name] = {
            "fault": fault, "losses": losses, "launches": launches,
            "params_local": sum(p.nelement() for p in eng.params),
            "peak_mem_gb": peak / 1e9,
            "collectives_per_step": {
                k: (first.n[k] + rest.n[k]) / REF_STEPS for k in first.n},
            "gaps": (hy_gaps(state, grads, ref["init"], ref["state"],
                             ref["grads"], HY_LR) if rank == 0 else None),
            "rep_gaps": (pp_rep_gaps(every, ref["init"], ref["state"])
                         if rank == 0 else None)}
        secs["gaps"] = lap()
        out[name]["seconds"] = {**secs, "run": t[-1] - t[0]}
        del eng, state, grads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pp_verdict(name, res, ref_losses):
    """What phase 46's check finds wrong in one run: ``hy_verdict``, and
    a rank whose replicated tensors left rank 0's."""
    bad = hy_verdict(name, res, ref_losses)
    for r, (k, gap) in enumerate(res[0]["rep_gaps"]):
        if not gap <= HY_MOVE_TOL:
            bad.append(f"{name}: rank {r}'s replicated {k} {gap} from rank "
                       f"0's over its movement > {HY_MOVE_TOL}")
    return bad


def sp_time_ms(fn):
    """Median host ms of ``fn`` over SP_REPS calls, each between a
    synchronize and a barrier of every rank (after one call untimed)."""
    from paddle1_tpu_torch import distributed as pdist
    ts = []
    for i in range(SP_REPS + 1):
        torch.cuda.synchronize()
        pdist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def seq_job(dev, out_dir):
    """Phase 47 on this rank: ring and Ulysses attention over the world
    at ERNIE's attention shape cut over the ranks (see SP_*), against
    attention_ref on the whole sequence on this rank; the errors, the
    launches of rows 3-5 and the times of each call."""
    from paddle1_tpu_torch import distributed as pdist
    from paddle1_tpu_torch.distributed import (ring_attention,
                                               ulysses_attention)
    from paddle1_tpu_torch.nn.functional.attention import attention_ref
    g = pdist.get_group()
    b, n, h, d = ERNIE_ATTN
    nl = n // g.nranks
    cut = slice(g.rank * nl, (g.rank + 1) * nl)
    gen = torch.Generator().manual_seed(SEED + 47)
    q, k, v, w = (torch.randn(b, n, h, d, generator=gen) for _ in range(4))
    w = w.to(dev)
    counters = train_counters()
    out = {"shape": [b, n, h, d], "local": [b, nl, h, d], "cases": []}
    for dtype in (torch.float32, torch.bfloat16):
        full = [t.to(dev, dtype).float().requires_grad_() for t in (q, k, v)]
        for causal in (False, True):
            ref = attention_ref(*full, is_causal=causal)
            (ref * w).sum().backward()
            want = [ref[:, cut].detach()] + [t.grad[:, cut] for t in full]
            for t in full:
                t.grad = None
            for name, fn in (("ring", ring_attention),
                             ("ulysses", ulysses_attention)):
                mine = [t[:, cut].detach().clone().requires_grad_()
                        for t in full]
                local = [t.detach().to(dtype).requires_grad_()
                         for t in mine]
                zero(counters)
                o = fn(*local, "sp", causal=causal, group=g)
                (o.float() * w[:, cut]).sum().backward()
                launches = {kk: fn_.launches for kk, fn_ in counters.items()
                            if kk.startswith("flash")}
                got = [o.detach()] + [t.grad for t in local]
                errs = [float((a.float() - bb).abs().max())
                        for a, bb in zip(got, want)]
                rels = [float((a.float() - bb).norm() / bb.norm())
                        for a, bb in zip(got, want)]

                def fwd(fn=fn, local=local, causal=causal):
                    with torch.no_grad():
                        fn(*local, "sp", causal=causal, group=g)

                def fwd_bwd(fn=fn, local=local, causal=causal):
                    oo = fn(*local, "sp", causal=causal, group=g)
                    (oo.float() * w[:, cut]).sum().backward()
                out["cases"].append({
                    "fn": name, "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "out_max_abs_err": errs[0],
                    "grad_max_abs_err": max(errs[1:]), "rel_err": rels,
                    "launches": launches, "fwd_ms": sp_time_ms(fwd),
                    "fwd_bwd_ms": sp_time_ms(fwd_bwd)})
        del full, ref, want
    # the one-rank paths beside them: attention_ref and the flash kernel
    # over the whole sequence
    one = [t.to(dev, torch.bfloat16).requires_grad_() for t in (q, k, v)]

    def dense():
        (attention_ref(*one) * w).sum().backward()

    def flash():
        from paddle1_tpu_torch.ops import flash_attention as fa
        (fa.flash_attention(*one).float() * w).sum().backward()
    out["one_rank_bf16_fwd_bwd_ms"] = {"attention_ref": sp_time_ms(dense),
                                       "flash": sp_time_ms(flash)}
    return out


def pp_rank_worker(out_dir, init_file, backend, one_card, jobs):
    """One rank of phases 46-47 (``distributed.spawn``): each job of
    ``jobs`` (``(name, args)``: ``ernie_pp_job``, ``pp_check_job``,
    ``seq_job``) in turn, its result saved to
    ``out_dir/<name>_rank<r>.pt``."""
    import os
    from paddle1_tpu_torch import distributed as pdist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    dev = torch.device(CARD, 0 if one_card else rank)
    pdist.init_parallel_env(backend=backend, device=dev,
                            init_method=f"file://{init_file}")
    try:
        for name, args in jobs:
            t0 = time.perf_counter()
            res = globals()[name](dev, out_dir, *args)
            res["job_seconds"] = time.perf_counter() - t0
            torch.save(res, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
            torch.cuda.empty_cache()
    finally:
        pdist.destroy_process_group()


def pp_spawn(tmp, ranks, jobs, timeout=PP_TIMEOUT_S):
    """``jobs`` on ``ranks`` ranks (gloo on one card, NCCL one a card
    where there are as many), killed after ``timeout`` s; every rank's
    result of each job."""
    import os
    from paddle1_tpu_torch import distributed as pdist
    nccl = torch.cuda.device_count() >= ranks
    pdist.spawn(pp_rank_worker, args=(
        tmp, os.path.join(tmp, f"store{ranks}"), "nccl" if nccl else "gloo",
        not nccl, jobs), nprocs=ranks, timeout=timeout)
    return {name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"))
                   for r in range(ranks)] for name, _ in jobs}


def pipeline_phases(dev, ws1):
    """Phases 46-47 (see PP_* and SP_*). ``ws1``: phase 44's summary (the
    world-size-1 step, peak and parameters). Returns both phases'
    summaries."""
    import os
    import tempfile
    t0 = time.perf_counter()
    model = pp_model()
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    eng = hy_engine(model)
    batch = ernie_batch(HY_BATCH, ERNIE_SEQ, seed=SEED + 46)
    ref_losses = [float(eng.step(batch))]
    ref_grads = {k: v.cpu() for k, v in eng.full_grad_dict().items()}
    ref_losses += [float(eng.step(batch)) for _ in range(REF_STEPS - 1)]
    ref = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del eng, model
    torch.cuda.empty_cache()
    meshes = {name: (degrees, kw) for name, degrees, kw in PP_MESHES}
    pp2 = [("pp2", *meshes["pp2"], None)] + \
        [(f"pp2_planted_{f}", *meshes["pp2"], f) for f in PP_PLANTS]
    dp2 = [("pp2_dp2", *meshes["pp2_dp2"], None)]
    seconds = {"reference": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"init": init, "state": ref, "grads": ref_grads},
                   os.path.join(tmp, "pp_ref.pt"))
        del init
        t1 = time.perf_counter()
        got = pp_spawn(tmp, PP_DEGREE, [("ernie_pp_job", ()),
                                        ("pp_check_job", (pp2,)),
                                        ("seq_job", ())])
        t2 = time.perf_counter()
        got4 = pp_spawn(tmp, 4, [("pp_check_job", (dp2,))])
        seconds.update(spawn2=t2 - t1, spawn4=time.perf_counter() - t2)
    for g in (got, got4):
        for job, res in g.items():
            seconds[f"{job}_{len(res)}"] = res[0]["job_seconds"]
    checks = {**{k: [r[k] for r in got["pp_check_job"]]
                 for k, *_ in pp2},
              **{k: [r[k] for r in got4["pp_check_job"]] for k, *_ in dp2}}
    failures = [f"phase 46 ran {r['backend']} on {n} ranks"
                for n, g in ((PP_DEGREE, got), (4, got4))
                for r in g["pp_check_job"]
                if r["backend"] != ("nccl" if torch.cuda.device_count() >= n
                                    else "gloo")]
    # config 4 at pp 2
    runs = got["ernie_pp_job"]
    r0 = runs[0]
    dt = float(np.median(r0["slopes"]))
    n_params, steps = r0["params_whole"], r0["steps"]
    flops = (6 * n_params * ERNIE_BATCH * ERNIE_SEQ +
             12 * ERNIE_LAYERS * ERNIE_BATCH * ERNIE_SEQ ** 2 * ERNIE_HIDDEN)
    stage = ERNIE_LAYERS // PP_DEGREE
    per_step = {"flash_attention": stage * PP_MICRO,
                "flash_attention_bwd_dkv": stage * PP_MICRO,
                "flash_attention_bwd_dq": stage * PP_MICRO,
                "fused_adam": 1, "layer_norm": 2 * stage * PP_MICRO + 2}
    pp46 = {
        "train": "ernie_1p5b_pretraining_fleet_pp", "card": card_line(),
        "ranks": PP_DEGREE, "backend": got["pp_check_job"][0]["backend"],
        "setup": [r["setup"] for r in runs], "amp": "bfloat16",
        "batch": ERNIE_BATCH, "micro_batches": PP_MICRO, "seq_len": ERNIE_SEQ,
        "layers": ERNIE_LAYERS, "params": n_params,
        "setup_s": r0["setup_s"], "steps": steps,
        "timing": "slope+readback, rank 0",
        "step_ms_median": dt * 1e3, "step_ms_min": min(r0["slopes"]) * 1e3,
        "step_ms_max": max(r0["slopes"]) * 1e3,
        "tokens_per_s": ERNIE_BATCH * ERNIE_SEQ / dt,
        "mfu": flops / dt / BF16_FLOPS_PER_S,
        "loss_first": [r["loss_first"] for r in runs],
        "loss_last": [r["loss_last"] for r in runs],
        "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
        "peak_mem_gb_world_size_1": ws1["peak_mem_gb"],
        "params_local": [r["params_local"] for r in runs],
        "slot_bytes": [r["slot_bytes"] for r in runs],
        "launches": [r["launches"] for r in runs],
        "launches_per_step": [{k: v / steps for k, v in r["launches"].items()}
                              for r in runs],
        "collectives_per_step": [{k: v / steps for k, v in
                                  r["collectives"].items()} for r in runs]}
    log(json.dumps({"ernie_fleet_pp": pp46}))
    for r in runs:
        if not (np.isfinite(r["loss_first"]) and np.isfinite(r["loss_last"])
                and r["loss_last"] < r["loss_first"]):
            failures.append(f"ERNIE at pp 2: loss {r['loss_first']} -> "
                            f"{r['loss_last']}")
        if r["loss_first"] != r0["loss_first"]:
            failures.append("ERNIE at pp 2: the ranks' losses differ")
        for k, v in per_step.items():
            if r["launches"][k] != v * steps:
                failures.append(f"ERNIE at pp 2: {k} launched "
                                f"{r['launches'][k]} times in {steps} "
                                f"steps, want {v * steps}")
        if not (r["params_local"] < ws1["params"] and
                r["peak_mem_gb"] < ws1["peak_mem_gb"]):
            failures.append(f"ERNIE at pp 2: a rank holds "
                            f"{r['params_local']} parameters at "
                            f"{r['peak_mem_gb']} GB peak, world size 1 "
                            f"{ws1['params']} at {ws1['peak_mem_gb']}")
    if any(s["micro"] != [PP_MICRO] or s["pp"] != PP_DEGREE
           for s in pp46["setup"]):
        failures.append(f"fleet compiled {pp46['setup']}")
    # the cross-rank check
    check_out = {"card": card_line(), "depth": PP_DEPTH, "batch": HY_BATCH,
                 "seq": ERNIE_SEQ, "dtype": "float32", "steps": REF_STEPS,
                 "lr": HY_LR, "losses_world_size_1": ref_losses}
    for name, degrees, kw, fault in pp2 + dp2:
        res = checks[name]
        verdict = pp_verdict(name, res, ref_losses)
        gaps = res[0]["gaps"]
        micro = kw["pp_microbatches"]
        check_out[name] = {
            "mesh": degrees, **kw, "fault": fault,
            "losses": [r["losses"] for r in res],
            "max_grad_gap": max(gaps["grad_gap"].values()),
            "max_move_gap": max(gaps["move_gap"].values()),
            "flat_gap_in_lr": gaps["flat_gap_in_lr"],
            "rep_gaps": res[0]["rep_gaps"],
            "verdict": verdict or "holds",
            "launches": [r["launches"] for r in res],
            "params_local": [r["params_local"] for r in res],
            "peak_mem_gb": [r["peak_mem_gb"] for r in res],
            "collectives_per_step": [r["collectives_per_step"]
                                     for r in res],
            "seconds": res[0]["seconds"]}
        log(json.dumps({"pp_rank_check_" + name: check_out[name]}))
        if fault is not None:
            if not verdict:
                failures.append(f"{name}: the planted fault {fault} passed "
                                "the check")
            continue
        failures += verdict
        blocks = PP_DEPTH // PP_DEGREE
        want = {"flash_attention": blocks * micro,
                "flash_attention_bwd_dkv": blocks * micro,
                "flash_attention_bwd_dq": blocks * micro, "fused_adam": 1,
                "layer_norm": 2 * blocks * micro + 2}
        for r in res:
            for k, v in want.items():
                if r["launches"][k] != v * REF_STEPS:
                    failures.append(f"{name}: a rank launched {k} "
                                    f"{r['launches'][k]} times, want "
                                    f"{v * REF_STEPS}")
    # phase 47
    seq = got["seq_job"]
    cases = seq[0]["cases"]
    for r in seq:
        for c in r["cases"]:
            tag = f"{c['fn']} {c['dtype']} causal={c['causal']}"
            if c["dtype"] == "float32":
                ok = c["out_max_abs_err"] <= SP_TOL and \
                    c["grad_max_abs_err"] <= SP_GRAD_TOL
            else:
                ok = max(c["rel_err"]) <= SP_BF16_REL
            if not ok:
                failures.append(f"phase 47 {tag}: errors {c}")
            want = 1 if c["fn"] == "ulysses" else 0
            if any(v != want for v in c["launches"].values()):
                failures.append(f"phase 47 {tag}: launches "
                                f"{c['launches']}, want {want} each")
    sp47 = {"card": card_line(), "ranks": SP_RANKS,
            "shape": seq[0]["shape"], "local": seq[0]["local"],
            "ulysses_kernel_shape": [ERNIE_BATCH, ERNIE_SEQ,
                                     ERNIE_HEADS // SP_RANKS,
                                     ERNIE_HIDDEN // ERNIE_HEADS],
            "tol": {"f32_out": SP_TOL, "f32_grad": SP_GRAD_TOL,
                    "bf16_rel": SP_BF16_REL},
            "cases": cases, "one_rank_bf16_fwd_bwd_ms":
                seq[0]["one_rank_bf16_fwd_bwd_ms"],
            "launches": {k: sum(c["launches"].get(k, 0) for r in seq
                                for c in r["cases"])
                         for k in cases[0]["launches"]}}
    log(json.dumps({"sequence_parallel": sp47}))
    seconds["total"] = time.perf_counter() - t0
    check_out["seconds"] = seconds
    log(json.dumps({"pp_rank_check": {
        k: v for k, v in check_out.items() if k not in checks}}))
    check(not failures, "; ".join(failures))
    return pp46, sp47


# ---------------------------------------------------------------------------
# phases 48-50: item 5(iv-b)-(v), the sequence cut inside the engine and
# ZeRO's memory scaling, and item 6's sharded checkpoint

# phase 48: config 4 through fleet at sharding_degree ZS_RANKS, bf16, 4 x
# 512 a rank, at ZeRO stages 1, 2 and 3 (gloo ranks on one card, NCCL one
# a card where there are as many), each stage from the same seeded
# weights: the peak a rank must fall with the stage, stage 3's below phase
# 44's world-size-1 peak, and the stages' losses agree within ZS_LOSS_TOL
# (the same sums in another order at most). ZS_STEPS steps a stage, the
# first a warm-up, the rest timed by the host clock (gloo moves the 6.55 GB
# of gradients and parameters of a step through host memory: a step takes
# seconds, and a slope over many steps too long).
ZS_RANKS, ZS_STAGES, ZS_STEPS, ZS_TIMEOUT_S = 2, (1, 2, 3), 2, 900
ZS_LOSS_TOL = 1e-3
# phase 49: the sequence cut, batch_spec SQ_SPEC. The f32 check at ERNIE's
# width cut to SQ_DEPTH layers on SQ_MESHES against world size 1 on the
# whole batch (ragged padding, dropout 0), by phase 45's measures and
# phase 46's replicated-tensor gaps; each fault of SQ_PLANTS, planted in its
# mesh, must fail it. Then config 4 at full width and depth through fleet
# at sep_degree SQ_RANKS, bf16, 4 x 512, SQ_STEPS steps.
SQ_RANKS, SQ_DEPTH, SQ_STEPS = 2, 4, 2
SQ_SPEC = (("dp", "sharding"), "sp")
SQ_MESHES = (("sp2", {"sp": 2}, {}), ("sp2_dp2", {"sp": 2, "dp": 2}, {}))
# the blocks' gradients not summed over sp; the input's gradient not
# all-gathered (each rank's embeddings miss the other slices); the key mask
# cut with the sequence (each rank's own slice tiled) instead of whole;
# one ZeRO unit's reduce-scatter written a 64-element step off its offset.
# Each with the mesh it is planted in.
SQ_PLANTS = {"sp_sum": "sp2", "input_grad": "sp2", "mask_cut": "sp2",
             "unit_offset": "sh2_z2"}
SQ_PLANT_MESHES = {"sh2_z2": ({"sharding": 2}, {"zero_stage": 2})}
# phase 50: depth CK_DEPTH, f32, sharding 2 at ZeRO 3 on two ranks:
# CK_STEPS steps, save, CK_STEPS more; a fresh engine restored takes the
# same CK_STEPS: the losses and the state bit for bit; then world size 1
# restores the same checkpoint, bit for bit.
CK_DEPTH, CK_STEPS = 2, 2


def sq_batch(batch, seq, seed, accum=None):
    """``ernie_batch`` with ragged padding: row i's last ``1 + i * seq //
    (3 * batch)`` ids are the pad id 0, which the model masks."""
    out = ernie_batch(batch, seq, seed=seed, accum=accum)
    ids = out["ids"].reshape(-1, batch, seq)
    for i in range(batch):
        ids[:, i, seq - 1 - (i * seq) // (3 * batch):] = 0
    return out


class PlantedSeq:
    """One fault of SQ_PLANTS planted in ``eng`` for the enclosed code
    (``with PlantedSeq(eng, fault):``): phase 49's check must fail each."""

    def __init__(self, eng, fault):
        if fault not in SQ_PLANTS:
            raise ValueError(f"no planted fault {fault!r}")
        self.eng, self.fault, self._undo = eng, fault, []

    def __enter__(self):
        from paddle1_tpu_torch.distributed import sequence_parallel as sqp
        eng, fault = self.eng, self.fault
        if fault == "sp_sum":
            eng._sum_seq = lambda grad: None
        elif fault == "unit_offset":
            real = eng._scatter_unit

            def shifted(u, g):
                real(u, g)
                if u is eng._zero["units"][1]:
                    u.gshard.copy_(u.gshard.roll(64))
            eng._scatter_unit = shifted
        elif fault == "input_grad":
            self._swap(sqp, "_seq_slice", _slice_without_gather)
        else:
            from paddle1_tpu_torch.nn import layer_transformer as lt
            mha = lt.MultiHeadAttention
            real = mha.forward

            def cut_mask(layer, query, key=None, value=None,
                         attn_mask=None, cache=None):
                group = getattr(lt._cut, "group", None)
                if attn_mask is not None and group is not None:
                    n, nl = group.nranks, query.shape[1]
                    mine = attn_mask[..., group.rank * nl:
                                     (group.rank + 1) * nl]
                    attn_mask = mine.repeat(
                        *([1] * (attn_mask.dim() - 1)), n)
                return real(layer, query, key, value, attn_mask, cache)
            self._swap(mha, "forward", cut_mask)
        return self

    def _swap(self, mod, name, fn):
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def __exit__(self, *exc):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        return False


class _SliceNoGather(torch.autograd.Function):
    """The planted slice: its backward puts this rank's cotangent in place
    and zeros elsewhere, where the real one all-gathers the slices'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[1]
        k = x.shape[1] // group.nranks
        return x[:, group.rank * k:(group.rank + 1) * k].contiguous()

    @staticmethod
    def backward(ctx, dy):
        full = dy.new_zeros((dy.shape[0], ctx.n) + tuple(dy.shape[2:]))
        k, r = dy.shape[1], ctx.group.rank
        full[:, r * k:(r + 1) * k] = dy
        return full, None


def _slice_without_gather(x, group):
    return _SliceNoGather.apply(x, group)


def zero_state_bytes(eng):
    """A ZeRO engine's state at rest on this rank (``_zero``'s units):
    parameter, gradient and slot bytes, the largest bytes gathered whole
    at any moment of a step (stage 3's counter; stages 1-2 hold the whole
    parameters) and stage 3's bound on it, the root unit and two of the
    largest blocks at the gathered leaves' element size (a block is
    gathered for its forward while the one before it is freed)."""
    z = eng._zero
    units = z["units"]
    whole = sum(u.n for u in units) * 4
    stage3 = eng.zero_stage >= 3
    root = sum(u.n for u in units if not u.block)
    block = max((u.n for u in units if u.block), default=0)
    esize = max((u.raw if u.cflat is None else u.craw).element_size()
                for u in units)
    return {"params": sum(u.size for u in units) * 4 if stage3 else whole,
            "grads": whole if eng.zero_stage == 1 else
            sum(u.size for u in units) * 4,
            "slots": eng.slot_bytes(),
            "max_gathered": z["max_gathered"] if stage3 else whole,
            "max_gathered_bound": esize * (root + 2 * block),
            "max_unit_gathered": z["max_unit_gathered"] if stage3 else
            max(u.n for u in units) * 4,
            "max_grad_buffer": z["max_grad_buffer"] * 4,
            "units": len(units), "largest_unit": max(u.n for u in units),
            "whole_grad_buffer": eng._flat is not None}


def host_steps_ms(step_fn, n):
    """The host ms and the loss of each of ``n`` steps, each ending in a
    readback."""
    ms, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step_fn()))
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, losses


def ernie_flops(tokens, layers=ERNIE_LAYERS, n_params=None):
    return 6 * n_params * tokens + 12 * layers * tokens * ERNIE_SEQ * \
        ERNIE_HIDDEN


# config 4's model in this rank's process, built once for phases 48-49
_RANK_MODEL = {}


def rank_ernie_model():
    """Config 4's model (``ernie_model()``) at its seeded initial
    weights: built on the first call in this process, reset to them on
    each later one (the last engine's parameters, whole, take them)."""
    if not _RANK_MODEL:
        m = ernie_model()
        _RANK_MODEL.update(model=m, init={
            k: v.detach().cpu().clone() for k, v in m.state_dict().items()})
    else:
        _RANK_MODEL["model"].load_state_dict(_RANK_MODEL["init"])
    return _RANK_MODEL["model"]


def zs_job(dev, out_dir):
    """Phase 48 on this rank: config 4 through fleet at sharding_degree
    ZS_RANKS, bf16, at each ZeRO stage of ZS_STAGES in turn, each from the
    same initial weights: peak memory, the state at rest, the largest bytes
    gathered, the losses, step ms, launches and collectives a step."""
    import gc
    from paddle1_tpu_torch.distributed import fleet, topology
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import BertPretrainingCriterion
    model = rank_ernie_model()
    n_params = sum(p.nelement() for p in model.parameters())
    batch = ernie_batch(ERNIE_BATCH * ZS_RANKS, ERNIE_SEQ, seed=48)
    out = {"params": n_params}
    for stage in ZS_STAGES:
        t0 = time.perf_counter()
        model = rank_ernie_model()
        strategy = fleet.DistributedStrategy()
        strategy.sharding = True
        strategy.sharding_configs = {"stage": stage}
        strategy.hybrid_configs = {"sharding_degree": ZS_RANKS}
        strategy.amp = True
        fleet.init(is_collective=True, strategy=strategy)
        try:
            eng = fleet.parallel_engine(
                model, AdamW(learning_rate=ERNIE_LR,
                             parameters=model.parameters()),
                ernie_loss_fn(BertPretrainingCriterion(ERNIE_VOCAB)))
            gc.collect()
            torch.cuda.empty_cache()
            staged = eng.shard_batch(batch)
            setup_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(dev)
            counters = train_counters()
            zero(counters)
            with CollectiveCount() as calls:
                losses = [float(eng.step(staged))]
                ms, more = host_steps_ms(lambda: eng.step(staged),
                                         ZS_STEPS - 1)
            torch.cuda.synchronize(dev)
            out[stage] = {
                "setup_s": setup_s, "mesh": eng.mesh.shape,
                "zero_stage": eng.zero_stage, "amp": str(eng.amp_dtype),
                "losses": losses + more,
                "step_ms": ms, "peak_mem_gb":
                    torch.cuda.max_memory_allocated(dev) / 1e9,
                "state": zero_state_bytes(eng),
                "launches": {k: fn.launches for k, fn in counters.items()},
                "collectives_per_step": {k: v / ZS_STEPS
                                         for k, v in calls.n.items()}}
            eng.sync_model()       # the model's parameters whole again
        finally:
            topology.set_hybrid_communicate_group(None)
        del eng, staged
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sq_ernie_job(dev, out_dir):
    """Phase 49's config-4 run on this rank: fleet at sep_degree SQ_RANKS,
    bf16, the sequence cut over sp (``fleet.parallel_engine(...,
    batch_spec=...)``), 4 x 512 with ragged padding: SQ_STEPS steps (the
    first a warm-up), peak memory, launches and collectives a step."""
    from paddle1_tpu_torch.distributed import fleet, topology
    from paddle1_tpu_torch.distributed.sharding_specs import \
        data_partition_spec
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import BertPretrainingCriterion
    t0 = time.perf_counter()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sep_degree": SQ_RANKS}
    strategy.amp = True
    fleet.init(is_collective=True, strategy=strategy)
    try:
        model = rank_ernie_model()
        n_params = sum(p.nelement() for p in model.parameters())
        eng = fleet.parallel_engine(
            model, AdamW(learning_rate=ERNIE_LR,
                         parameters=model.parameters()),
            ernie_loss_fn(BertPretrainingCriterion(ERNIE_VOCAB)),
            batch_spec=data_partition_spec(("dp", "sharding"),
                                           seq_axis="sp"))
        staged = eng.shard_batch(sq_batch(ERNIE_BATCH, ERNIE_SEQ, seed=49))
        setup = {"mesh": eng.mesh.shape, "amp": str(eng.amp_dtype),
                 "cut": eng._sp is not None}
        torch.cuda.reset_peak_memory_stats(dev)
        loss0 = float(eng.step(staged))
        setup_s = time.perf_counter() - t0
        counters = train_counters()
        zero(counters)
        with CollectiveCount() as calls:
            ms, losses = host_steps_ms(lambda: eng.step(staged),
                                       SQ_STEPS - 1)
        torch.cuda.synchronize(dev)
        return {"setup": setup, "setup_s": setup_s, "params": n_params,
                "loss_first": loss0, "loss_last": losses[-1],
                "step_ms": ms, "steps": SQ_STEPS - 1,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "launches": {k: fn.launches for k, fn in counters.items()},
                "collectives_per_step": {k: v / (SQ_STEPS - 1)
                                         for k, v in calls.n.items()}}
    finally:
        topology.set_hybrid_communicate_group(None)


def sq_model(depth=SQ_DEPTH):
    return ernie_model(depth=depth, seed=SEED + 49)


def sq_check_job(dev, out_dir, runs):
    """Phase 49's cross-rank check on this rank: each run of ``runs``
    (``(name, degrees, engine kwargs, planted fault or None)``), REF_STEPS
    f32 steps of the depth-cut ERNIE on the global batch with the sequence
    cut over sp, the first step's gradient and the state gathered; rank 0
    reads the gaps to world size 1 (``hy_gaps``, the reference in
    ``out_dir``) and every rank's replicated-tensor gaps to it."""
    import contextlib
    import copy
    import gc
    import os
    from paddle1_tpu_torch import distributed as pdist
    rank = pdist.get_rank()
    batch = sq_batch(HY_BATCH, ERNIE_SEQ, seed=SEED + 49)
    ref = None
    if rank == 0:
        raw = torch.load(os.path.join(out_dir, "sq_ref.pt"), mmap=True)
        ref = {part: {k: v.to(dev) for k, v in raw[part].items()}
               for part in ("init", "state", "grads")}
        del raw
    out = {"backend": torch.distributed.get_backend()}
    first_model = sq_model()
    for name, degrees, kw, fault in runs:
        t0 = time.perf_counter()
        model = copy.deepcopy(first_model)
        eng = hy_engine(model, mesh=pdist.build_mesh(**degrees),
                        batch_spec=SQ_SPEC, **kw)
        del model
        counters = train_counters()
        zero(counters)
        torch.cuda.reset_peak_memory_stats(dev)
        plant = PlantedSeq(eng, fault) if fault is not None else \
            contextlib.nullcontext()
        with plant:
            with CollectiveCount() as first:
                losses = [float(eng.step(batch))]
            grads = eng.full_grad_dict()
            with CollectiveCount() as rest:
                for _ in range(REF_STEPS - 1):
                    losses.append(float(eng.step(batch)))
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: fn.launches for k, fn in counters.items()}
        state = eng.full_state_dict()
        norms = pp_rep_norms(state, dev)
        every = []
        pdist.all_gather_object(every, norms)
        out[name] = {
            "fault": fault, "losses": losses, "launches": launches,
            "peak_mem_gb": peak / 1e9,
            "collectives_per_step": {
                k: (first.n[k] + rest.n[k]) / REF_STEPS for k in first.n},
            "gaps": (hy_gaps(state, grads, ref["init"], ref["state"],
                             ref["grads"], HY_LR) if rank == 0 else None),
            "rep_gaps": (pp_rep_gaps(every, ref["init"], ref["state"])
                         if rank == 0 else None),
            "seconds": time.perf_counter() - t0}
        del eng, state, grads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ck_model(seed=SEED + 50):
    return ernie_model(depth=CK_DEPTH, seed=seed)


def ck_job(dev, out_dir):
    """Phase 50 on this rank: CK_STEPS f32 steps at sharding ZS_RANKS, ZeRO
    3, a save, CK_STEPS more; a fresh engine (other weights) restored takes
    the same steps. Returns both runs' losses, whether the states agree bit
    for bit, and the save's and restore's seconds and bytes; rank 0 keeps
    the state at the save for world size 1's restore."""
    import os
    from paddle1_tpu_torch import distributed as pdist
    rank = pdist.get_rank()
    path = os.path.join(out_dir, "ck")
    batch = ernie_batch(HY_BATCH, ERNIE_SEQ, seed=SEED + 50)
    mesh = pdist.build_mesh(sharding=ZS_RANKS)
    eng = hy_engine(ck_model(), mesh=mesh, zero_stage=3)
    for _ in range(CK_STEPS):
        eng.step(batch)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    at_save = eng.full_state_dict()
    if rank == 0:
        torch.save({k: v.cpu() for k, v in at_save.items()},
                   os.path.join(out_dir, "ck_state.pt"))
    del at_save
    want = [float(eng.step(batch)) for _ in range(CK_STEPS)]
    whole = eng.full_state_dict()
    del eng
    torch.cuda.empty_cache()
    again = hy_engine(ck_model(seed=SEED + 51), mesh=mesh, zero_stage=3)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    again.load_checkpoint(path)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    got = [float(again.step(batch)) for _ in range(CK_STEPS)]
    resumed = again.full_state_dict()
    return {"losses": want, "resumed_losses": got,
            "state_bit_equal": all(torch.equal(whole[k], resumed[k])
                                   for k in whole) and
            set(whole) == set(resumed),
            "save_s": save_s, "load_s": load_s,
            "bytes": os.path.getsize(os.path.join(path,
                                                  f"shard-{rank:05d}.pt"))}


def zero_seq_phases(dev, ws1):
    """Phases 48-50 (see ZS_*, SQ_*, CK_*). ``ws1``: phase 44's summary
    (the world-size-1 step and peak). Returns the three summaries."""
    import os
    import tempfile
    from paddle1_tpu_torch import distributed as pdist
    t0 = time.perf_counter()
    model = sq_model()
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    eng = hy_engine(model)
    batch = sq_batch(HY_BATCH, ERNIE_SEQ, seed=SEED + 49)
    ref_losses = [float(eng.step(batch))]
    ref_grads = {k: v.cpu() for k, v in eng.full_grad_dict().items()}
    ref_losses += [float(eng.step(batch)) for _ in range(REF_STEPS - 1)]
    ref = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del eng, model
    torch.cuda.empty_cache()
    meshes = {name: (degrees, kw) for name, degrees, kw in SQ_MESHES}
    meshes.update(SQ_PLANT_MESHES)
    runs = [(name, *meshes[name], None) for name, *_ in SQ_MESHES] + \
        [(f"{m}_planted_{f}", *meshes[m], f) for f, m in SQ_PLANTS.items()]
    runs2 = [r for r in runs if int(np.prod(list(r[1].values()))) == 2]
    runs4 = [r for r in runs if int(np.prod(list(r[1].values()))) == 4]
    seconds = {"reference": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"init": init, "state": ref, "grads": ref_grads},
                   os.path.join(tmp, "sq_ref.pt"))
        del init
        t1 = time.perf_counter()
        got = pp_spawn(tmp, ZS_RANKS, [("zs_job", ()), ("sq_ernie_job", ()),
                                       ("sq_check_job", (runs2,)),
                                       ("ck_job", ())], ZS_TIMEOUT_S)
        t2 = time.perf_counter()
        got4 = pp_spawn(tmp, 4, [("sq_check_job", (runs4,))])
        t3 = time.perf_counter()
        # world size 1 restores phase 50's checkpoint
        one = hy_engine(ck_model(seed=SEED + 52))
        one.load_checkpoint(os.path.join(tmp, "ck"))
        at_save = torch.load(os.path.join(tmp, "ck_state.pt"))
        mine = one.full_state_dict()
        ws1_equal = set(mine) == set(at_save) and all(
            torch.equal(mine[k].cpu(), at_save[k]) for k in at_save)
        del one, mine, at_save
        torch.cuda.empty_cache()
        seconds.update(spawn2=t2 - t1, spawn4=t3 - t2,
                       ws1_restore=time.perf_counter() - t3)
    for g in (got, got4):
        for job, res in g.items():
            seconds[f"{job}_{len(res)}"] = res[0]["job_seconds"]
    failures = [f"phases 48-50 ran {r['backend']} on {n} ranks"
                for n, g in ((ZS_RANKS, got), (4, got4))
                for r in g["sq_check_job"]
                if r["backend"] != ("nccl" if torch.cuda.device_count() >= n
                                    else "gloo")]
    per_step = {"flash_attention": ERNIE_LAYERS,
                "flash_attention_bwd_dkv": ERNIE_LAYERS,
                "flash_attention_bwd_dq": ERNIE_LAYERS, "fused_adam": 1,
                "layer_norm": 2 * ERNIE_LAYERS + 2}
    # phase 48
    zs = got["zs_job"]
    n_params = zs[0]["params"]
    zs48 = {"card": card_line(), "ranks": ZS_RANKS, "backend":
            got["sq_check_job"][0]["backend"], "amp": "bfloat16",
            "batch_per_rank": ERNIE_BATCH, "seq_len": ERNIE_SEQ,
            "layers": ERNIE_LAYERS, "params": n_params,
            "peak_mem_gb_world_size_1": ws1["peak_mem_gb"],
            "timing": "host clock a step, readback each, rank 0"}
    for stage in ZS_STAGES:
        rs = [r[stage] for r in zs]
        dt = float(np.median(rs[0]["step_ms"])) / 1e3
        steps = ZS_STEPS
        zs48[f"zero{stage}"] = {
            "mesh": rs[0]["mesh"], "setup_s": [r["setup_s"] for r in rs],
            "losses": [r["losses"] for r in rs],
            "step_ms": [r["step_ms"] for r in rs],
            "step_ms_median": dt * 1e3,
            "tokens_per_s_per_rank": ERNIE_BATCH * ERNIE_SEQ / dt,
            "mfu": ernie_flops(ERNIE_BATCH * ERNIE_SEQ, n_params=n_params) /
            dt / BF16_FLOPS_PER_S,
            "peak_mem_gb": [r["peak_mem_gb"] for r in rs],
            "state_bytes": [r["state"] for r in rs],
            "launches": [r["launches"] for r in rs],
            "launches_per_step": [{k: v / steps for k, v in
                                   r["launches"].items()} for r in rs],
            "collectives_per_step": [r["collectives_per_step"] for r in rs]}
        for r in rs:
            if not (r["zero_stage"] == stage and
                    r["mesh"]["sharding"] == ZS_RANKS and
                    r["amp"] == "torch.bfloat16"):
                failures.append(f"phase 48: fleet compiled {r['mesh']}, "
                                f"zero {r['zero_stage']}, {r['amp']}")
            ls = r["losses"]
            if not (np.all(np.isfinite(ls)) and ls == rs[0]["losses"]):
                failures.append(f"phase 48 zero {stage}: losses {ls}, rank "
                                f"0's {rs[0]['losses']}")
            for k, v in per_step.items():
                if r["launches"][k] != v * steps:
                    failures.append(f"phase 48 zero {stage}: {k} launched "
                                    f"{r['launches'][k]} times in {steps} "
                                    f"steps, want {v * steps}")
            st = r["state"]
            if stage >= 2 and (st["whole_grad_buffer"] or
                               st["max_grad_buffer"] >
                               4 * st["largest_unit"]):
                failures.append(f"phase 48 zero {stage}: a whole-model "
                                f"gradient buffer ({st})")
            if stage == 3 and st["max_gathered"] > st["max_gathered_bound"]:
                failures.append(f"phase 48 zero 3: {st['max_gathered']} "
                                "bytes gathered at once, above the root "
                                "unit and two blocks' "
                                f"{st['max_gathered_bound']}")
    gap = max(abs(a - b) for st in ZS_STAGES
              for a, b in zip(zs[0][st]["losses"], zs[0][1]["losses"]))
    zs48["max_loss_gap_between_stages"] = gap
    if not gap <= ZS_LOSS_TOL:
        failures.append(f"phase 48: the stages' losses differ by {gap} "
                        f"> {ZS_LOSS_TOL}")
    log(json.dumps({"zero_memory_scaling": zs48}))
    for r in range(ZS_RANKS):
        peaks = [zs[r][s]["peak_mem_gb"] for s in ZS_STAGES]
        if not (peaks[2] < peaks[1] < peaks[0] and
                peaks[2] < ws1["peak_mem_gb"]):
            failures.append(f"phase 48: rank {r}'s peaks {peaks} GB at ZeRO "
                            f"1/2/3 do not fall (world size 1: "
                            f"{ws1['peak_mem_gb']})")
    # phase 49: config 4 at sep_degree 2
    runs = got["sq_ernie_job"]
    r0 = runs[0]
    dt = float(np.median(r0["step_ms"])) / 1e3
    sq49 = {"train": "ernie_1p5b_pretraining_fleet_sp", "card": card_line(),
            "ranks": SQ_RANKS, "setup": [r["setup"] for r in runs],
            "amp": "bfloat16", "batch": ERNIE_BATCH, "seq_len": ERNIE_SEQ,
            "seq_per_rank": ERNIE_SEQ // SQ_RANKS, "layers": ERNIE_LAYERS,
            "params": r0["params"], "setup_s": r0["setup_s"],
            "timing": "host clock a step, readback each, rank 0",
            "step_ms": [r["step_ms"] for r in runs],
            "step_ms_median": dt * 1e3,
            "tokens_per_s": ERNIE_BATCH * ERNIE_SEQ / dt,
            "mfu": ernie_flops(ERNIE_BATCH * ERNIE_SEQ,
                               n_params=r0["params"]) / dt / BF16_FLOPS_PER_S,
            "loss_first": [r["loss_first"] for r in runs],
            "loss_last": [r["loss_last"] for r in runs],
            "peak_mem_gb": [r["peak_mem_gb"] for r in runs],
            "launches": [r["launches"] for r in runs],
            "launches_per_step": [{k: v / r["steps"] for k, v in
                                   r["launches"].items()} for r in runs],
            "collectives_per_step": [r["collectives_per_step"]
                                     for r in runs],
            "ulysses_kernel_shape": list(ULYSSES_ATTN)}
    log(json.dumps({"ernie_fleet_sp": sq49}))
    for r in runs:
        if not (r["setup"]["cut"] and r["setup"]["mesh"]["sp"] == SQ_RANKS):
            failures.append(f"phase 49: fleet compiled {r['setup']}")
        if not (np.isfinite(r["loss_first"]) and np.isfinite(r["loss_last"])
                and r["loss_last"] == r0["loss_last"] and
                r["loss_first"] == r0["loss_first"]):
            failures.append(f"phase 49: losses {r['loss_first']} -> "
                            f"{r['loss_last']}, rank 0's {r0['loss_first']} "
                            f"-> {r0['loss_last']}")
        for k, v in per_step.items():
            if r["launches"][k] != v * r["steps"]:
                failures.append(f"phase 49: {k} launched {r['launches'][k]}"
                                f" times in {r['steps']} steps, want "
                                f"{v * r['steps']}")
    # phase 49: the cross-rank check
    checks = {**{k: [r[k] for r in got["sq_check_job"]] for k, *_ in runs2},
              **{k: [r[k] for r in got4["sq_check_job"]] for k, *_ in runs4}}
    check_out = {"card": card_line(), "depth": SQ_DEPTH, "batch": HY_BATCH,
                 "seq": ERNIE_SEQ, "dtype": "float32", "steps": REF_STEPS,
                 "lr": HY_LR, "losses_world_size_1": ref_losses}
    blocks = SQ_DEPTH
    want = {"flash_attention": blocks, "flash_attention_bwd_dkv": blocks,
            "flash_attention_bwd_dq": blocks, "fused_adam": 1,
            "layer_norm": 2 * blocks + 2}
    for name, degrees, kw, fault in runs2 + runs4:
        res = checks[name]
        verdict = pp_verdict(name, res, ref_losses)
        gaps = res[0]["gaps"]
        check_out[name] = {
            "mesh": degrees, **kw, "fault": fault,
            "losses": [r["losses"] for r in res],
            "max_grad_gap": max(gaps["grad_gap"].values()),
            "max_move_gap": max(gaps["move_gap"].values()),
            "flat_gap_in_lr": gaps["flat_gap_in_lr"],
            "rep_gaps": res[0]["rep_gaps"], "verdict": verdict or "holds",
            "launches": [r["launches"] for r in res],
            "peak_mem_gb": [r["peak_mem_gb"] for r in res],
            "collectives_per_step": [r["collectives_per_step"]
                                     for r in res],
            "seconds": [r["seconds"] for r in res]}
        log(json.dumps({"sq_rank_check_" + name: check_out[name]}))
        if fault is not None:
            if not verdict:
                failures.append(f"{name}: the planted fault {fault} passed "
                                "the check")
            continue
        failures += verdict
        for r in res:
            for k, v in want.items():
                if r["launches"][k] != v * REF_STEPS:
                    failures.append(f"{name}: a rank launched {k} "
                                    f"{r['launches'][k]} times, want "
                                    f"{v * REF_STEPS}")
    # phase 50
    ck = got["ck_job"]
    ck50 = {"card": card_line(), "ranks": ZS_RANKS, "depth": CK_DEPTH,
            "dtype": "float32", "zero_stage": 3, "steps": CK_STEPS,
            "losses": [r["losses"] for r in ck],
            "resumed_losses": [r["resumed_losses"] for r in ck],
            "state_bit_equal": [r["state_bit_equal"] for r in ck],
            "world_size_1_restore_bit_equal": ws1_equal,
            "save_s": [r["save_s"] for r in ck],
            "load_s": [r["load_s"] for r in ck],
            "bytes_per_rank": [r["bytes"] for r in ck]}
    log(json.dumps({"sharded_checkpoint": ck50}))
    for r in ck:
        if r["losses"] != r["resumed_losses"] or not r["state_bit_equal"]:
            failures.append(f"phase 50: the resumed run {r['resumed_losses']}"
                            f" is not the uninterrupted {r['losses']} bit for "
                            "bit")
    if not ws1_equal:
        failures.append("phase 50: world size 1's restore differs from the "
                        "state at the save")
    seconds["total"] = time.perf_counter() - t0
    log(json.dumps({"zero_seq_phases_seconds": seconds}))
    check(not failures, "; ".join(failures))
    return zs48, sq49, ck50


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
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, under ``name`` (the breakdown the
        smoke prints before its kernels line)."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

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

    lap("phases_1_3")
    flash_errs = flash_check(dev)
    flash_t, flash_b, flash_shape = flash_timing(dev)
    flash_te, flash_be, flash_shape_e = flash_timing(dev, ERNIE_ATTN)
    flash_tf, flash_bf, flash_shape_f = flash_timing(
        dev, FT_ATTN, torch.float32, ragged=True)
    adam = adam_phase(dev)
    ln_train = train_layer_norm_case(dev)
    # ERNIE-1.5B's whole batch, and one microbatch a stage step (phase 46)
    ln_ernie = [train_layer_norm_case(dev, rows, ERNIE_HIDDEN, dt)
                for rows in (ERNIE_BATCH * ERNIE_SEQ, ERNIE_SEQ)
                for dt in (torch.bfloat16, torch.float32)]
    ln_ft = train_layer_norm_case(dev, FT_BATCH * FT_SEQ, BERT_HIDDEN,
                                  torch.float32)
    kernels["layer_norm"] += [ln_train] + ln_ernie + [ln_ft]
    torch.cuda.empty_cache()
    train = train_phase(dev)
    torch.cuda.empty_cache()
    train_reference_check(dev)
    torch.cuda.empty_cache()

    lap("phases_4_8")
    bn_errs = bn_check(dev)
    bn_times = bn_timing(dev)
    rn = resnet_phase(dev)
    torch.cuda.empty_cache()
    resnet_reference_check(dev)
    torch.cuda.empty_cache()

    lap("phases_9_11")
    mom_errs, mom_times = moments_phase(dev)
    dp = resnet_dp_phase(dev, rn)
    torch.cuda.empty_cache()
    cross_rank_check(dev)

    lap("phases_12_13")
    sm_errs, sm_times, sm_grad_err = softmax_phase(dev)
    lenet = lenet_phase(dev)
    lenet_reference_check(dev)
    torch.cuda.empty_cache()

    lap("phases_14_15")
    yolo_bn_errs, yolo_bn_times = yolo_bn_phase(dev)
    yolo = yolo_phase(dev)
    yolo_reference_check(dev)
    torch.cuda.empty_cache()

    lap("phases_16_18")
    adam_e = adam_ernie_phase(dev)
    ernie = ernie_phase(dev)
    ernie_reference_check(dev)
    torch.cuda.empty_cache()

    lap("phases_19_20")
    ft = finetune_phase(dev)
    finetune_reference_check(dev)
    torch.cuda.empty_cache()

    lap("phases_21_22")
    ops_phase(dev)
    fte = finetune_eval_phase(dev)["bert_finetune_eval"]["launches"]
    torch.cuda.empty_cache()

    lap("phases_23_24")
    f16k = f16_kernels_phase(dev)
    amp = finetune_amp_phase(dev, ft)
    o2 = o2_phase(dev)
    torch.cuda.empty_cache()

    lap("phases_25_27")
    nn_launches = nn_phase(dev)["nn_cases"]["bn_launches"]
    mn = mobilenet_phase(dev)
    torch.cuda.empty_cache()

    lap("phases_28_29")
    flash_cross = flash_cross_phase(dev)
    ln_tf = train_layer_norm_case(dev, TF_BUCKETS[0][0] * TF_BUCKETS[0][2],
                                  TF_D, torch.float32)
    tfm, tf_train = transformer_phase(dev)
    tf_dec = transformer_decode_phase(dev, tfm)
    del tfm
    torch.cuda.empty_cache()
    transformer_reference_check(dev)
    torch.cuda.empty_cache()
    tf_paths = {"transformer": tf_train["launches"],
                "transformer_beam_search": tf_dec["end_token"]["launches"],
                "transformer_beam_search_length_limit":
                    tf_dec["length_limit"]["launches"]}

    lap("phases_30_31")
    ls_sm = ls_softmax_hold(dev)
    lsm, ls_train = lstm_seq2seq_phase(dev)
    ls_dec = lstm_decode_phase(dev, lsm)
    del lsm
    torch.cuda.empty_cache()
    lstm_cell_equivalence(dev)
    lstm_reference_check(dev)
    torch.cuda.empty_cache()
    ls_paths = {"lstm_seq2seq_train": ls_train["launches"],
                "lstm_seq2seq_beam_search": ls_dec["end_token"]["launches"],
                "lstm_seq2seq_beam_search_length_limit":
                    ls_dec["length_limit"]["launches"]}

    lap("phases_32_33")
    io_rn = io_resnet_phase(dev, rn["step_ms_median"])
    torch.cuda.empty_cache()
    io_ln = io_lenet_phase(dev, lenet["step_ms_median"])
    torch.cuda.empty_cache()

    lap("phases_34_35")
    t36 = time.perf_counter()
    gen16 = gen_f16_phase(dev, reqs)
    econ = decode_economics_phase(dev, reqs, outs)
    rs = resnet_server_phase(dev)
    log(json.dumps({"phases_36_38_s": time.perf_counter() - t36}))
    lap("phases_36_38")
    bn16_errs, bn16_times = bn_f16_phase(dev)
    torch.cuda.empty_cache()
    rn16 = resnet_f16_phase(dev)
    yt = yolo_train_phase(dev)
    yt_ref = yolo_train_reference_check(dev)
    vgg = vgg_phase(dev)
    torch.cuda.empty_cache()

    lap("phases_39_42")
    t43 = time.perf_counter()
    collectives_phase(dev)
    fleet_e = ernie_fleet_phase(dev)
    hybrid_rank_check(dev)
    log(json.dumps({"phases_43_45_s": time.perf_counter() - t43}))
    lap("phases_43_45")
    t46 = time.perf_counter()
    pp46, sp47 = pipeline_phases(dev, fleet_e)
    log(json.dumps({"phases_46_47_s": time.perf_counter() - t46}))
    lap("phases_46_47")
    t48 = time.perf_counter()
    zs48, sq49, ck50 = zero_seq_phases(dev, fleet_e)
    # rows 2-5 at the sequence cut's shapes: row 2 on a rank's slice in the
    # blocks, rows 3-5 at Ulysses' heads with the ragged keep-mask
    ln_sp = [train_layer_norm_case(dev, ERNIE_BATCH * ERNIE_SEQ // SQ_RANKS,
                                   ERNIE_HIDDEN, dt)
             for dt in (torch.bfloat16, torch.float32)]
    kernels["layer_norm"] += ln_sp
    flash_tu, flash_bu, flash_shape_u = flash_timing(dev, ULYSSES_ATTN,
                                                     ragged=True)
    log(json.dumps({"phases_48_50_s": time.perf_counter() - t48}))
    lap("phases_48_50")
    zs_launches = [r for st in ZS_STAGES
                   for r in zs48[f"zero{st}"]["launches"]]
    log(json.dumps({"phase_seconds": laps}))
    gen_paths = {"gen_f16_cache": gen16["f16_cache"]["launches"],
                 "gen_f16_model": gen16["f16_model"]["launches"],
                 "gen_spec": econ["spec"]["launches"],
                 "gen_int8": econ["int8"]["launches"],
                 "gen_preempt": econ["preempt"]["launches"]}

    mn_paths = {"mobilenet_v2_train": mn["launches_train"],
                "mobilenet_v2_eval": mn["launches_eval"],
                "mobilenet_v2_bf16": mn["bf16_engine"]["launches"],
                "nn_cases": nn_launches}
    # the launches of the AMP runs (each read over its own zeroed window)
    amp_paths = {"bert_finetune_amp_bf16": amp["bf16"]["launches"],
                 "bert_finetune_amp_f16": amp["f16"]["launches"],
                 "bert_finetune_o2_bf16": o2["bfloat16"]["launches"],
                 "bert_finetune_o2_f16": o2["float16"]["launches"]}

    src = "paddle1_tpu_torch/ops/cuda/"
    pallas = "paddle1_tpu/ops/pallas/"
    tl = train["launches"]
    line = []
    for name in ("paged_attention", "layer_norm"):
        main_case = kernels[name][0]     # the decode step's shape
        err = max(c["max_abs_err"] for c in kernels[name])
        by_path = {"serving": launches[name], "train": tl.get(name, 0),
                   "ernie": ernie["launches"].get(name, 0),
                   "ernie_fleet": fleet_e["launches"].get(name, 0),
                   "ernie_fleet_pp": sum(r.get(name, 0)
                                         for r in pp46["launches"]),
                   "ernie_fleet_zero": sum(r.get(name, 0)
                                           for r in zs_launches),
                   "ernie_fleet_sp": sum(r.get(name, 0)
                                         for r in sq49["launches"]),
                   "bert_finetune": ft["launches"].get(name, 0),
                   "bert_finetune_eval": fte.get(name, 0),
                   **{k: v.get(name, 0) for k, v in amp_paths.items()},
                   **{k: v.get(name, 0) for k, v in tf_paths.items()},
                   **{k: v[name] for k, v in gen_paths.items()}}
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
            "bf16_check": kernels[name + "_bf16"],
            # float16 (phase 2's f16 cases; phase 36's f16 arms)
            "f16_cases": kernels[name + "_f16"],
            "f16_max_abs_err": max(c["max_abs_err"]
                                   for c in kernels[name + "_f16"])})
    # row 1 at the speculative window W = 1 + SPEC_K (phase 37)
    line[0]["spec_window"] = {
        "window": 1 + SPEC_K,
        "launches_per_window": LAYERS,
        "draft_model_runs": econ["spec"]["draft_model_runs"],
        "f16_w5_cases": [c for c in kernels["paged_attention_f16"]
                         if c["window"] == 1 + SPEC_K]}
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
    # a sequence-cut rank's slice in the blocks (bf16 [1024, 2304]; f32 in
    # ernie_sp_f32_case)
    line[-1].update({f"ernie_sp_shape_{k}": ln_sp[0][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")})
    line[-1]["ernie_sp_shape"] = ln_sp[0]["shape"]
    line[-1]["ernie_sp_f32_case"] = ln_sp[1]
    line[-1]["launches_per_ernie_forward"] = 2 * ERNIE_LAYERS + 2
    # the fine-tuning path's (f32 [4096, 768])
    line[-1].update({f"bert_finetune_shape_{k}": ln_ft[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")})
    line[-1]["bert_finetune_shape"] = ln_ft["shape"]
    line[-1]["launches_per_bert_finetune_forward"] = 2 * BERT_LAYERS + 1
    # Transformer-base's (f32 [4096, 512] under auto_cast's black list)
    line[-1].update({f"transformer_shape_{k}": ln_tf[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")})
    line[-1]["transformer_shape"] = ln_tf["shape"]
    line[-1]["launches_per_transformer_forward"] = 5 * TF_LAYERS
    line[-1]["launches_per_beam_search_step"] = 3 * TF_LAYERS
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
                   "ernie_fleet": fleet_e["launches"][name],
                   "ernie_fleet_pp": sum(r[name] for r in pp46["launches"]),
                   "ernie_fleet_zero": sum(r[name] for r in zs_launches),
                   "ernie_fleet_sp": sum(r[name] for r in sq49["launches"]),
                   "ulysses_attention": sp47["launches"][name],
                   "bert_finetune": ft["launches"][name],
                   "bert_finetune_eval": fte[name],
                   **{k: v[name] for k, v in amp_paths.items()},
                   **{k: v[name] for k, v in tf_paths.items()}}
        f16t = f16k["flash_timing"]
        ct = flash_cross["times_ms"]
        line.append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": rep, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in
                               flash_errs[key] + flash_cross["errors"][key]),
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
            # the sequence cut's Ulysses heads (phase 49), ragged keep-mask
            "ulysses_shape": flash_shape_u, "ulysses_shape_ms": flash_tu[key],
            "ulysses_shape_plain_ms": flash_tu[plain_key],
            "ulysses_shape_bound_ms": flash_bu[key][0],
            "ulysses_shape_bound_by": flash_bu[key][1],
            "ulysses_shape_library_ms": flash_tu[lib_key],
            "bert_finetune_shape": flash_shape_f,
            "bert_finetune_shape_ms": flash_tf[key],
            "bert_finetune_shape_plain_ms": flash_tf[plain_key],
            "bert_finetune_shape_bound_ms": flash_bf[key][0],
            "bert_finetune_shape_bound_by": flash_bf[key][1],
            "bert_finetune_shape_library_ms": flash_tf[lib_key],
            "cases": flash_errs[key] + flash_cross["errors"][key],
            # Transformer-base's cross-attention (phase 30): 128 queries
            # against 256 keys
            "cross_attention_shape": flash_cross["shape"],
            "cross_attention_ms": ct[key],
            "cross_attention_plain_ms": ct[plain_key],
            "cross_attention_bound_ms": flash_cross["bounds_ms"][key],
            "cross_attention_bound_by": flash_cross["bound_by"][key],
            "cross_attention_library_ms": ct[lib_key],
            # float16 (phase 25): its errors, and its times at the
            # fine-tuning shape (ragged padding) and ERNIE-1.5B's
            "f16_max_abs_err": max(c["max_abs_err"]
                                   for c in f16k["flash_errors"][key]),
            "f16_cases": f16k["flash_errors"][key],
            **{f"f16_{where}_{k}": f16t[where][field][sub] for where in
               ("bert_finetune", "ernie") for k, field, sub in (
                   ("ms", "ms", key), ("plain_ms", "ms", plain_key),
                   ("bound_ms", "bound_ms", key),
                   ("bound_by", "bound_by", key),
                   ("library_ms", "ms", lib_key))},
            "f16_shapes": {w: f16t[w]["shape"] for w in f16t}})
    by_path = {"train": tl["fused_adam"],
               "lenet_train": lenet["launches"]["fused_adam"],
               "ernie": ernie["launches"]["fused_adam"],
               "ernie_fleet": fleet_e["launches"]["fused_adam"],
               "ernie_fleet_pp": sum(r["fused_adam"]
                                     for r in pp46["launches"]),
               "ernie_fleet_zero": sum(r["fused_adam"] for r in zs_launches),
               "ernie_fleet_sp": sum(r["fused_adam"]
                                     for r in sq49["launches"]),
               "bert_finetune": ft["launches"]["fused_adam"],
               **{k: v["fused_adam"] for k, v in amp_paths.items()},
               "transformer": tf_train["launches"]["fused_adam"],
               "lstm_seq2seq_train": ls_train["launches"]["fused_adam"],
               "lenet_mnist_io": io_ln["launches"]["fused_adam"]}
    line.append({
        "name": "fused_adam", "route": "cuda", "source": src + "fused_adam.cu",
        "replaces": pallas + "fused_adam.py:39",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max([c["max_abs_err"] for c in adam["cases"]] +
                           [c["max_abs_err"] for c in
                            f16k["fused_adam"]["cases"]] +
                           [adam_e["max_abs_err"],
                            adam_e["max_abs_err_bf16"],
                            ls_train["adam"]["max_abs_err"]]),
        "f16": f16k["fused_adam"],
        "ms": adam["ms"], "ms_mixed_lr_scales": adam["ms_mixed_lr_scales"],
        "f32": adam["f32"], "bf16": adam["bf16"],
        "plain_ms": adam["plain_ms"],
        "bound_ms": adam["bound_ms"], "bound_by": adam["bound_by"],
        "library_ms": adam["library_ms"], "tensors": adam["tensors"],
        "elements": adam["elements"], "cases": adam["cases"],
        "ernie_scale": adam_e,
        # the LSTM seq2seq's 27 M f32 parameters (phase 32)
        "lstm_seq2seq_scale": ls_train["adam"]})
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
                   "yolov3": yolo["launches"][name],
                   **{k: v[name] for k, v in mn_paths.items()},
                   "resnet_io_train": io_rn["launches_train"][name],
                   "resnet_io_eval": io_rn["launches_eval"][name],
                   "resnet_server": rs["launches"][name],
                   "resnet_f16_train": rn16["launches_train"][name],
                   "resnet_f16_eval": rn16["launches_eval"][name],
                   "resnet_f16_dp": rn16["launches_dp"][name],
                   "yolov3_train": yt["launches"][name],
                   "yolov3_train_reference": sum(
                       r["launches"][name] for r in yt_ref["steps"]),
                   "vgg16_bn_eval": vgg["launches"][name]}
        main_case = bn_times[name][0]     # the stem's [401408, 64]
        f16_main = bn16_times[name][0]    # the stem's, in f16
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
        line[-1].update({
            "mobilenet_v2_launches_per_step": mn["launches_per_step"][name],
            "mobilenet_v2_timing_cases": mn["bn_times_f32"][name],
            # float16 (phase 39): f16 rows over f16 and f32 parameters
            "f16_max_abs_err": max(c["max_abs_err"]
                                   for c in bn16_errs[name]),
            "f16_cases": bn16_errs[name],
            **{f"f16_{k}": f16_main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "f16_shape": f16_main["shape"],
            "f16_timing_cases": bn16_times[name],
            "yolov3_train_launches_per_step":
                yt["launches_per_step"].get(name, 0),
            "yolov3_train_shapes": [list(YOLO_TRAIN_STEM), "... 72 at "
                                    f"{YT_BATCH} x {YT_IMG}²"]})
        if name == "fused_bn_norm":
            line[-1].update({
                "max_abs_err": max([line[-1]["max_abs_err"]] + [
                    c["max_abs_err"] for c in yolo_bn_errs]),
                "yolov3_launches_per_forward":
                    yolo["launches_per_forward"][name],
                "yolov3_timing_cases": yolo_bn_times,
                "yolov3_cases": yolo_bn_errs})
    main_case = mom_times[0]     # the stem's [401408, 64]
    mom_paths = {"resnet_dp": dp["launches_train"]["fused_bn_moments"],
                 "resnet_f16_dp": rn16["launches_dp"]["fused_bn_moments"]}
    f16_main = bn16_times["fused_bn_moments"][0]
    line.append({
        "name": "fused_bn_moments", "route": "cuda",
        "source": src + "fused_bn.cu", "replaces": pallas + "fused_bn.py:357",
        "launches": sum(mom_paths.values()), "launches_by_path": mom_paths,
        "f16_max_abs_err": max(c["max_abs_err"] for c in
                               bn16_errs["fused_bn_moments"]),
        "f16_cases": bn16_errs["fused_bn_moments"],
        **{f"f16_{k}": f16_main[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "f16_shape": f16_main["shape"],
        "f16_timing_cases": bn16_times["fused_bn_moments"],
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
    sm_paths = {"lenet_predict": lenet["predict_launches"]["softmax"],
                "mobilenet_v2_eval": mn["launches_eval"]["softmax"],
                **{k: v["softmax"] for k, v in ls_paths.items()},
                "lenet_mnist_io_test": io_ln["test_launches"]["softmax"]}
    line.append({
        "name": "softmax", "route": "cuda", "source": src + "softmax.cu",
        "replaces": pallas + "softmax.py:40",
        "launches": sum(sm_paths.values()), "launches_by_path": sm_paths,
        "max_abs_err": max(c["max_abs_err"] for c in sm_errs + ls_sm),
        # the LSTM seq2seq's attention scores (phases 32-33), f32
        "lstm_seq2seq_cases": ls_sm,
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
