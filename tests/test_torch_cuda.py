"""Checks of the PyTorch port that need a CUDA card.

Marked ``cuda``; without a card they skip. On the card, from the repo
root (this file imports nothing of JAX, so the JAX test conftest is
left out)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

They hold that on CUDA tensors the functionals always go through the
kernels' wrappers: inputs outside a kernel's contract raise instead of
running the plain version, and a bf16 KV pool under f32 queries runs the
kernel and agrees with the plain version. For the training kernels
(flash forward, its dK/dV and dQ passes, fused AdamW) they hold the
same, the bf16 and f16 tensor-core forward, dK/dV and dQ passes to their
plain versions at every D bucket, causal and padded, fused AdamW in f32,
bf16 and f16 on unaligned views, that a tiny BERT step on the card
launches each of them, and that eager steps of a tiny BERT classifier
under ``amp.auto_cast`` (O1, and O2 through ``amp.decorate``; bf16, and
f16 with ``GradScaler``) launch them in the AMP dtype; the LayerNorm
kernel to its plain version on the warp-per-row and block-per-row paths,
with and without 16-byte vectors, in f32, bf16 and f16; paged attention
in f16 (f16 or f32 queries over f16 pools, windows of 1 and 5) and the
generation engine's per-(seed, token) generators on the card
(speculative == plain == ``eager_generate``). For the
fused batch-norm family (training and given-statistics forward, their
backward passes) they hold each kernel to its plain version across the
activation x residual matrix in f32 and bf16 (and, since F24, in f16
over f16 or f32 parameters, at fresh and 16-byte-offset views, with an
f16 ResNet-18 engine step on the kernels), that inputs outside the
contract raise, and that tiny ResNet-18 train, eval and frozen-statistics
steps launch the kernels once per batch norm; and that the training
backward (one cooperative launch holding its rows in shared memory) and
the given-statistics forward hold to their plain versions at ResNet-50's
layer-4 and layer-3 shapes and at a shape only partly resident, repeat bit
for bit, replay inside a CUDA graph as they ran eagerly, and that a
refused cooperative launch raises; the same of the training forward (one
cooperative launch holding x in shared memory) at layers 4 and 2 and a
partly resident shape. For paged attention (split across the cache, the
splits merged by the last CTA of a slot and head) they hold the kernel to
its plain version and to the emulation of its split arithmetic at the
serving shape with one long slot among short ones, every slot long,
slots ending on split boundaries and slots that see no key, and at a
table of 64 pages; repeats bit for bit, a CUDA graph replayed twice, and
that a first call inside a capture raises. For the local-moments
kernel (the cross-rank batch norm's per-rank statistics) they hold it to
its plain version, its contract, and that a tiny ResNet-18 step of the
data-parallel engine (one rank, no process group) launches it once per
batch norm in place of the training kernels. The local moments and the
given-statistics backward are one launch each (the last CTA of each
channel tile sums the partial rows): they hold both to their plain
versions at ResNet-50's four shapes, at one chunk a tile and at a short
ragged shape, repeats bit for bit, one kernel each in a profile, 53
alternating calls replayed in a CUDA graph as they ran eagerly, and that a
first call inside a capture raises. For the row-softmax kernel
(the eager slice) they hold it to its plain version on every path (lane
groups of 1 to 32 lanes, an element a lane for few short rows, a block a
row from shared memory up to the on-chip limit, two passes past it), at
16-byte-aligned and odd start offsets, in f32, bf16 and f16, with masked,
all -inf and +inf rows, repeats bit for bit and a CUDA-graph replay; its
contract, refused plans raising, its launch counter, and integer input
promoted onto the kernel by ``F.softmax``; and that the eager LeNet runs
on the card by default, on Paddle tensors whose ``.numpy()`` reads the
card, with one fused Adam launch per step and one softmax launch per
prediction. They also hold an affine-less batch norm to the plain
composition on the kernels (F18), rows 8,
9 and 11 to their plain versions at MobileNetV2's 19 batch-norm shapes,
and that a tiny MobileNetV2's eager steps and eval launch them once per
batch norm. For the Transformer path they hold rows 3-5 to their plain
versions at Transformer-base's cross-attention shape (128 queries against
256 keys, bf16, ragged), and that a narrow ``nn.Transformer`` step under
``amp.auto_cast`` launches rows 3-5 once per encoder self-attention and
cross-attention, row 2 once per LayerNorm and row 6 once, and a beam
search row 3 on the encoder only. For the attention LSTM seq2seq they hold
row 7 to its plain version at the path's attention scores (f32 ``[128, 1,
50]`` and ``[320, 1, 50]``, ragged pads at -1e9), that a narrow model's
steps launch row 7 once per decoder step and row 6 once a step and a beam
search row 7 once a decode step, and ``nn.LSTM`` (cuDNN) equal to
``nn.RNN(nn.LSTMCell)`` over the same weights, forward and gradients.
For the input pipeline they hold that ``io.DataLoader`` batches staged on
the card through pinned memory on the loader's copy stream equal their
host arrays over 50 batches while a matmul loop keeps the compute stream
busy, read at once and again after the loop (a missing ``wait_event``
reads a copy not yet landed; a missing ``record_stream`` lets the next
batch's copy reuse memory the compute stream has yet to read), with the
producer thread and with worker processes.
"""

import numpy as np
import pytest
import torch

from paddle1_tpu_torch.core.errors import (InvalidArgumentError,
                                           KernelLaunchError)
from paddle1_tpu_torch.nn import functional as F
from paddle1_tpu_torch.ops import flash_attention as fa
from paddle1_tpu_torch.ops import flash_attention_bwd as fb
from paddle1_tpu_torch.ops import fused_adam as fad
from paddle1_tpu_torch.ops import fused_bn as fbn
from paddle1_tpu_torch.ops import fused_bn_bwd as fbb
from paddle1_tpu_torch.ops import layer_norm as ln
from paddle1_tpu_torch.ops import paged_attention as pa
from paddle1_tpu_torch.ops import softmax as psm

pytestmark = pytest.mark.cuda

PA_TOL = 2e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _paged(dev, w=1, h=2, d=16, ps=8, mpps=4, q_dtype=torch.float32,
           kv_dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    s_ = 3
    n_pages = s_ * mpps + 1
    q = torch.from_numpy(rng.standard_normal((s_, w, h, d)).astype(
        np.float32)).to(dev, q_dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, h, d)).astype(np.float32)).to(dev, kv_dtype)
        for _ in range(2))
    table = torch.zeros(s_, mpps, dtype=torch.int32)
    table[:2] = torch.arange(1, 2 * mpps + 1, dtype=torch.int32).view(2, -1)
    pos = torch.tensor([5, mpps * ps - 1, w], dtype=torch.int32)
    return q, kp, vp, table.to(dev), pos.to(dev)


def test_layer_norm_outside_the_contract_raises_on_the_card(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.float64)
    w = torch.ones(64, device=dev, dtype=torch.float64)
    with pytest.raises(InvalidArgumentError, match="contract"):
        F.layer_norm(x, 64, w, torch.zeros_like(w))


@pytest.mark.parametrize("kw", [
    dict(q_dtype=torch.float64, kv_dtype=torch.float64),
    dict(kv_dtype=torch.float64),
    dict(w=600, h=2, d=64, ps=16),   # past one CTA's shared memory
])
def test_paged_attention_outside_the_contract_raises_on_the_card(dev, kw):
    q, kp, vp, table, pos = _paged(dev, **kw)
    with pytest.raises(InvalidArgumentError, match="contract"):
        F.paged_attention(q, kp, vp, table, pos)


def test_f32_query_over_bf16_pools_runs_the_kernel(dev):
    q, kp, vp, table, pos = _paged(dev, w=2, kv_dtype=torch.bfloat16)
    before = pa.paged_attention.launches
    got = F.paged_attention(q, kp, vp, table, pos)
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_ref(q, kp, vp, table, pos - 2)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= PA_TOL


# float16 rows 1-2 against their plain versions: one f16 rounding step
# of the value (2^-10, one unit in the last place at the bottom of a
# binade: both sides round their own f32 result) plus the f32 tolerance
F16_REL = 2.0 ** -10


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float16, torch.float16), (torch.float32, torch.float16),
    (torch.bfloat16, torch.float16), (torch.float16, torch.float32),
    (torch.float16, torch.bfloat16)])
@pytest.mark.parametrize("w", [1, 5])
def test_f16_paged_attention_runs_the_kernel(dev, q_dtype, kv_dtype, w):
    q, kp, vp, table, pos = _paged(dev, w=w, d=64, ps=16, q_dtype=q_dtype,
                                   kv_dtype=kv_dtype)
    assert pa.supported(q.shape, kp.shape, q_dtype, kv_dtype)
    before = pa.paged_attention.launches
    got = F.paged_attention(q, kp, vp, table, pos)
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_ref(q, kp, vp, table, pos - w)
    assert got.dtype == q_dtype
    step = {torch.float16: F16_REL, torch.bfloat16: 2.0 ** -7}.get(
        q_dtype, 0.0)
    assert _bf16_excess(got, want, step) <= PA_TOL
    assert torch.equal(F.paged_attention(q, kp, vp, table, pos), got)


def _serving_paged(dev, bases, kv_dtype=torch.float32, w=1, seed=0):
    """The serving shape: 16 slots, 8 heads of 64, pages of 16, 32 pages a
    slot, each slot's chain on its own pages of a 513-page pool."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((16, w, 8, 64)).astype(
        np.float32)).to(dev)
    kp, vp = (torch.randn(513, 16, 8, 64, device=dev).to(kv_dtype)
              for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, 513))
                             .astype(np.int32).reshape(16, 32)).to(dev)
    return q, kp, vp, table, torch.tensor(bases, dtype=torch.int32,
                                          device=dev)


# one slot at 496 among 15 shorter than one split, every slot long, a
# slot ending on each split boundary, and slots that see no key
PAGED_BASES = {
    "skewed": [496] + [3 * i % 24 for i in range(15)],
    "long": [511 - i for i in range(16)],
    "boundaries": [16 * k - 1 for k in range(1, 17)],
    "empty": [-1, 0, -5] + [100] * 13,
}


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.float16])
@pytest.mark.parametrize("kind", list(PAGED_BASES))
def test_paged_attention_splits_match_and_repeat(dev, kind, kv_dtype):
    q, kp, vp, table, base = _serving_paged(dev, PAGED_BASES[kind],
                                            kv_dtype)
    got = pa.paged_attention(q, kp, vp, table, base)
    seen = base >= 0                      # rows that see at least key 0
    want = pa.paged_attention_ref(q, kp, vp, table, base)
    assert float((got - want)[seen].abs().max()) <= PA_TOL
    emu = pa.paged_attention_split_emulation(q, kp, vp, table, base)
    assert float((got - emu).abs().max()) <= PA_TOL
    assert bool((got[~seen] == 0).all())
    assert torch.equal(pa.paged_attention(q, kp, vp, table, base), got)


@pytest.mark.parametrize("w", [1, 4])
def test_paged_attention_replays_in_a_cuda_graph(dev, w):
    q, kp, vp, table, base = _serving_paged(dev, PAGED_BASES["skewed"],
                                            w=w)
    run = lambda: pa.paged_attention(q, kp, vp, table, base)  # noqa: E731
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    # the counters the kernel resets: an eager call after the replays
    assert torch.equal(run(), eager)


def test_paged_attention_first_call_inside_a_capture_raises(dev):
    # its partials and counters must exist before a graph captures it
    q, kp, vp, table, base = _serving_paged(dev, PAGED_BASES["long"],
                                            w=3)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(KernelLaunchError, match="outside CUDA-graph"):
        with torch.cuda.graph(graph):
            pa.paged_attention(q, kp, vp, table, base)


def test_paged_attention_splits_a_wide_table(dev):
    # 64 pages a slot: 16 splits of 4 pages, two query rows
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((4, 2, 2, 64)).astype(
        np.float32)).to(dev)
    kp, vp = (torch.randn(257, 16, 2, 64, device=dev) for _ in range(2))
    table = torch.from_numpy(rng.permutation(np.arange(1, 257)).astype(
        np.int32).reshape(4, 64)).to(dev)
    base = torch.tensor([1000, 70, 1022, 300], dtype=torch.int32,
                        device=dev)
    got = pa.paged_attention(q, kp, vp, table, base)
    want = pa.paged_attention_ref(q, kp, vp, table, base)
    assert float((got - want).abs().max()) <= PA_TOL
    assert torch.equal(pa.paged_attention(q, kp, vp, table, base), got)


def test_layer_norm_on_the_card_runs_the_kernel(dev):
    x = torch.randn(2, 3, 8, 16, device=dev)
    w, b = torch.randn(8, 16, device=dev), torch.randn(8, 16, device=dev)
    before = ln.fused_layer_norm.launches
    got = F.layer_norm(x, [8, 16], w, b)
    assert ln.fused_layer_norm.launches == before + 1
    want = torch.nn.functional.layer_norm(x, (8, 16), w, b, 1e-5)
    assert float((got - want).abs().max()) <= 1e-5


# LayerNorm kernel against its plain version: f32 to LN_TOL (the same
# sums in another order), bf16 to one rounding step of the output
LN_TOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [64, 100, 512, 768, 1000, 1024, 1025, 4096])
def test_layer_norm_kernel_matches_its_plain_version(dev, dtype, h):
    """The warp-per-row path (H <= 1024, 16-byte vectors when H allows,
    scalar loads at H = 100 in bf16) and the block-per-row path (1025:
    scalar, 4096: vectors), over 1, 7 and 16384 rows."""
    g = torch.Generator(device=dev).manual_seed(h)
    w, b = (torch.randn(h, device=dev, generator=g).to(dtype)
            for _ in range(2))
    for rows in (1, 7, 16384):
        x = (torch.randn(rows, h, device=dev, generator=g) * 2 + 0.3).to(
            dtype)
        before = ln.fused_layer_norm.launches
        got = ln.fused_layer_norm(x, w, b)
        assert ln.fused_layer_norm.launches == before + 1
        want = ln.layer_norm_ref(x, w, b)
        assert got.dtype == dtype and got.shape == x.shape
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= LN_TOL, rows
        elif dtype == torch.float16:
            assert _bf16_excess(got, want, F16_REL) <= LN_TOL, rows
        else:
            assert _bf16_excess(got, want) <= 1e-5, rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_layer_norm_kernel_takes_an_unaligned_view(dev, dtype):
    """A view whose start is off 16 bytes takes the scalar loads."""
    h = 768
    flat = torch.randn(7 * h + 1, device=dev).to(dtype)
    x = flat[1:].view(7, h)
    w, b = (torch.randn(h, device=dev).to(dtype) for _ in range(2))
    got = ln.fused_layer_norm(x, w, b)
    want = ln.layer_norm_ref(x, w, b)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= LN_TOL
    elif dtype == torch.float16:
        assert _bf16_excess(got, want, F16_REL) <= LN_TOL
    else:
        assert _bf16_excess(got, want) <= 1e-5


def test_sampling_schedule_speculative_equals_plain_on_the_card(dev):
    """The per-(seed, token index) CUDA generators: a speculative engine
    (drafts that are the stream's own continuation, so most are taken)
    and a plain one draw the same sampled tokens on the card, and the
    reference eager loop draws them too."""
    from paddle1_tpu_torch.serving import (CausalLM, GenerationEngine,
                                           eager_generate)
    lm = CausalLM(64, d_model=64, nhead=4, num_layers=2, max_seq=64,
                  device=dev, generator=torch.Generator().manual_seed(0))
    prompt = np.asarray([3, 9, 4, 7, 1], np.int32)
    kw = dict(temperature=0.9, top_k=16, seed=21)
    want = eager_generate(lm, prompt, 12, **kw)
    for k in (0, 3):
        eng = GenerationEngine(lm, slots=2, max_seq=64, paged=True,
                               page_size=16, spec_tokens=k)
        got = [eng.prefill(1, prompt, kw["temperature"], kw["top_k"],
                           kw["seed"])]
        active = np.asarray([False, True])
        while len(got) < 12:
            d = np.asarray(want[len(got):len(got) + k], np.int64)
            drafts = np.zeros((2, k), np.int64)
            drafts[1, :d.size] = d
            toks, flags = eng.decode(active, drafts,
                                     np.asarray([0, d.size]))
            got += [int(t) for t in toks[1][flags[1]]]
        assert got[:12] == want, k


def _qkv(dev, shape=(2, 128, 2, 64), dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=g).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("shape,dtype", [
    ((2, 128, 2, 64), torch.float64),
    ((2, 96, 2, 64), torch.float32),     # ragged N
    ((2, 128, 2, 60), torch.float32),    # d % 8
])
def test_flash_outside_the_contract_raises_on_the_card(dev, shape, dtype):
    q, k, v = _qkv(dev, shape, dtype)
    with pytest.raises(InvalidArgumentError, match="contract"):
        fa.flash_fwd(q, k, v, 0.125)


def test_sdpa_padding_mask_runs_the_flash_kernels_forward_and_back(dev):
    q, k, v = (t.requires_grad_() for t in _qkv(dev))
    keep = torch.ones(2, 128, dtype=torch.bool, device=dev)
    keep[0, 100:] = False
    keep[1] = False                       # a fully padded batch row
    before = (fa.flash_fwd.launches, fb.flash_bwd_dkv.launches,
              fb.flash_bwd_dq.launches)
    out = F.scaled_dot_product_attention(q, k, v,
                                         attn_mask=keep[:, None, None, :])
    dout = torch.randn_like(out)
    (out * dout).sum().backward()
    assert (fa.flash_fwd.launches, fb.flash_bwd_dkv.launches,
            fb.flash_bwd_dq.launches) == tuple(b + 1 for b in before)
    ref_o, ref_l = fa.flash_attention_ref(q.detach(), k.detach(),
                                          v.detach(), 0.125, False, keep)
    ref_g = fa.flash_bwd_ref(q.detach(), k.detach(), v.detach(), ref_o,
                             ref_l, dout, 0.125, False, keep)
    assert float((out.detach() - ref_o).abs().max()) <= 1e-5
    for got, want in zip((q.grad, k.grad, v.grad), ref_g):
        assert float((got - want).abs().max()) <= 1e-4
        assert float(got[1].abs().max()) == 0.0   # the padded row


# bf16 flash against its plain version: one bf16 rounding step of the
# value (2^-7 relative) plus the f32 difference (chip_smoke.py's
# FLASH_BF16_ABS); LSE in f32 to 1e-5 (FLASH_TOL)
FLASH_BF16_ABS, FLASH_TOL = 1e-4, 1e-5


def _bf16_excess(got, want, step=2.0 ** -7):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - step * want.abs()).max())


TC_FLASH_CASES = [
    (256, 256, 64, False), (256, 256, 64, True), (128, 256, 64, True),
    (256, 256, 128, False), (128, 256, 128, True), (256, 256, 256, False),
    (128, 256, 256, True), (128, 128, 40, False), (128, 256, 96, True),
]


@pytest.mark.parametrize("nq,nk,d,causal", TC_FLASH_CASES)
def test_bf16_tensor_core_flash_matches_its_plain_version(dev, nq, nk, d,
                                                          causal):
    """The tensor-core forward, dK/dV and dQ passes at each D bucket (64,
    128, 256; 40 and 96 zero-padded in shared memory), causal and padded,
    one batch row fully padded; all three repeat bit for bit."""
    _tc_flash_case(dev, nq, nk, d, causal, torch.bfloat16, 2.0 ** -7)


@pytest.mark.parametrize("nq,nk,d,causal", TC_FLASH_CASES)
def test_f16_tensor_core_flash_matches_its_plain_version(dev, nq, nk, d,
                                                         causal):
    """The same in float16 (the f16 form of the product): one f16 rounding
    step of each stored value (2^-10 relative) beyond the bf16 bounds'
    f32 difference; all three repeat bit for bit."""
    _tc_flash_case(dev, nq, nk, d, causal, torch.float16, 2.0 ** -10)


def _tc_flash_case(dev, nq, nk, d, causal, dtype, step):
    g = torch.Generator(device=dev).manual_seed(nq + nk + d)
    q, do = (torch.randn(3, nq, 2, d, device=dev, generator=g).to(
        dtype) for _ in range(2))
    k, v = (torch.randn(3, nk, 2, d, device=dev, generator=g).to(
        dtype) for _ in range(2))
    keep = torch.ones(3, nk, dtype=torch.bool, device=dev)
    keep[0, nk // 2 + 3:] = False
    keep[1] = False
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, causal, keep)
    ro, rl = fa.flash_attention_ref(q, k, v, scale, causal, keep)
    assert out.dtype == dtype
    assert _bf16_excess(out, ro, step) <= FLASH_BF16_ABS
    live = rl > -1e29
    assert torch.equal(lse > -1e29, live)
    assert float((lse - rl)[live].abs().max()) <= FLASH_TOL
    assert float(out[1].abs().max()) == 0.0
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, causal, keep)
    dq = fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, causal, keep)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, ro, rl, do, scale, causal, keep)
    for got, want in ((dk, rk), (dv, rv), (dq, rq)):
        assert got.dtype == dtype
        assert _bf16_excess(got, want, step) <= FLASH_BF16_ABS
    assert float(dk[1].abs().max()) == float(dv[1].abs().max()) == 0.0
    assert float(dq[1].abs().max()) == 0.0
    out2, lse2 = fa.flash_fwd(q, k, v, scale, causal, keep)
    dk2, dv2 = fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, causal, keep)
    dq2 = fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, causal, keep)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, dq2)


def test_bf16_flash_takes_unaligned_views(dev):
    """A view that does not start on 16 bytes is copied by the wrapper
    before the kernel's 16-byte copies see it."""
    q, k, v = _qkv(dev, (2, 128, 2, 64), torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    qv = flat[1:].view_as(q)
    qv.copy_(q)
    keep = torch.ones(4, 129, dtype=torch.bool, device=dev)[:2, 1:]
    got, _ = fa.flash_fwd(qv, k, v, 0.125, False, keep)
    want, _ = fa.flash_fwd(q, k, v, 0.125, False, keep.contiguous())
    assert torch.equal(got, want)


def test_fused_adam_outside_the_contract_raises_on_the_card(dev):
    p = torch.zeros(10, device=dev, dtype=torch.float64)
    m = torch.zeros(10, device=dev)
    sc = torch.zeros(3, device=dev)
    with pytest.raises(InvalidArgumentError, match="contract"):
        fad.fused_adam_([p], [p], [m], [m], sc, [0.0], 0.9, 0.999, 1e-8)
    p32 = torch.zeros(10, device=dev)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        fad.fused_adam_([p32], [p32.to(torch.bfloat16)], [m], [m], sc,
                        [0.0], 0.9, 0.999, 1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_fused_adam_on_unaligned_views_is_bit_for_bit(dev, dtype):
    """Row 6 over views at element offsets into larger buffers (one common
    odd offset: a scalar head, then 16-byte vectors; offsets that never
    align together: all scalar; odd lengths: a scalar tail; several
    chunks) equals the plain version on the card and the kernel on
    aligned copies of the same data, bit for bit."""
    g = torch.Generator(device=dev).manual_seed(11)
    layout = [((7,), (0, 0, 0, 0)), ((33, 5), (1, 1, 1, 1)),
              ((129,), (1, 2, 3, 1)), ((2,), (3, 3, 3, 3)),
              ((3 * fad.CHUNK + 5,), (5, 5, 5, 5)), ((64, 3), (0, 1, 0, 0))]
    views = ([], [], [], [])
    for shape, offs in layout:
        n = int(np.prod(shape))
        for j, (lst, off) in enumerate(zip(views, offs)):
            t = torch.randn(n + off, device=dev, generator=g)
            t = t.to(dtype) if j < 2 else (t.abs() if j == 3 else t) * 0.01
            lst.append(t[off:].view(shape))
    aligned = tuple([t.clone() for t in ts] for ts in views)
    sc = torch.tensor([1e-3, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    decays = [(0.01, 0.0)[i % 2] for i in range(len(layout))]
    scales = [(1.0, 0.5, 2.0)[i % 3] for i in range(len(layout))]
    want = [fad.fused_adam_ref(p, q, a, b, sc[0], sc[1], sc[2], d, 0.9,
                               0.999, 1e-8, s)
            for p, q, a, b, d, s in zip(*views, decays, scales)]
    before = fad.fused_adam_.launches
    for ts in (views, aligned):
        fad.fused_adam_(*ts, sc, decays, 0.9, 0.999, 1e-8, scales)
    torch.cuda.synchronize()
    assert fad.fused_adam_.launches == before + 2
    for i, w in enumerate(want):
        for j, k in ((0, 0), (2, 1), (3, 2)):
            assert torch.equal(views[j][i], w[k]), (i, j)
            assert torch.equal(views[j][i], aligned[j][i]), (i, j)


def test_adamw_step_is_one_launch_and_matches_the_plain_update(dev):
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.optimizer import AdamW

    def run(mode):
        g = torch.Generator(device=dev).manual_seed(3)
        ps = [torch.nn.Parameter(torch.randn(s, device=dev, generator=g))
              for s in ((300, 70), (70,), (5, 5, 5))]
        opt = AdamW(learning_rate=1e-2, parameters=ps)
        with flags_guard(fused_adam=mode):
            for _ in range(3):
                for p in ps:
                    p.grad = torch.randn(p.shape, device=dev, generator=g)
                opt.step()
        return ps
    before = fad.fused_adam_.launches
    fused = run("auto")
    assert fad.fused_adam_.launches == before + 3   # one per step
    plain = run("never")
    assert fad.fused_adam_.launches == before + 3
    for a, b in zip(fused, plain):
        assert float((a - b).detach().abs().max()) <= 1e-6


def test_tiny_bert_step_on_the_card_launches_every_kernel(dev):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import (BertForPretraining,
                                               BertModel,
                                               BertPretrainingCriterion)
    torch.manual_seed(0)
    m = BertForPretraining(BertModel(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    crit = BertPretrainingCriterion(512)
    eng = ParallelEngine(m, AdamW(learning_rate=1e-3, parameters=m.parameters()),
                         lambda mm, b: crit(*mm(b["ids"]), b["mlm"], b["nsp"]),
                         amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, (2, 128)).astype(np.int32)
    ids[1, 90:] = 0
    batch = {"ids": ids, "mlm": rng.integers(0, 512, (2, 128)),
             "nsp": rng.integers(0, 2, (2,))}
    counts = lambda: (fa.flash_fwd.launches, fb.flash_bwd_dkv.launches,
                      fb.flash_bwd_dq.launches, fad.fused_adam_.launches,
                      ln.fused_layer_norm.launches)
    before = counts()
    losses = [float(eng.step(batch)) for _ in range(3)]
    got = [a - b for a, b in zip(counts(), before)]
    # 2 layers: 2 flash fwd/dkv/dq per step; 1 Adam launch per step;
    # 2 LayerNorms per layer + embeddings + MLM head per forward
    assert got == [6, 6, 6, 3, 3 * 6]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tiny_bert_eager_steps_under_auto_cast_run_the_kernels(
        dev, monkeypatch, level, amp_dtype):
    """Eager steps of a tiny BERT classifier under ``auto_cast`` (f16 with
    ``GradScaler``): the flash passes launch on ``amp_dtype`` tensors, 2
    a step each, LayerNorm on f32 (black-listed) 5 a forward, fused AdamW
    once an applied step; at O1 every gradient is f32 and row 6 updates
    f32 parameters, at O2 (``decorate``) the parameters and row 6 are in
    ``amp_dtype``; the losses are finite."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.text.models import (BertForSequenceClassification,
                                               BertModel)
    dt = getattr(torch, amp_dtype)
    with paddle.utils.unique_name.guard():
        clf = BertForSequenceClassification(BertModel(
            vocab_size=512, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            generator=torch.Generator().manual_seed(0)), dropout=0.0)
    opt = paddle.optimizer.AdamW(1e-4, parameters=clf.parameters())
    if level == "O2":
        clf, opt = paddle.amp.decorate(clf, opt, level="O2", dtype=amp_dtype)
    scaler = paddle.amp.GradScaler(enable=amp_dtype == "float16",
                                   init_loss_scaling=2.0 ** 10)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 512, (2, 128))
    ids[1, 90:] = 0
    x = paddle.to_tensor(ids)
    y = paddle.to_tensor(rng.integers(0, 2, 2))
    seen = []
    check = fa._check

    def spy(name, q, *a):
        seen.append(q.dtype)
        return check(name, q, *a)
    monkeypatch.setattr(fa, "_check", spy)
    counts = lambda: (fa.flash_fwd.launches, fb.flash_bwd_dkv.launches,  # noqa
                      fb.flash_bwd_dq.launches, ln.fused_layer_norm.launches,
                      fad.fused_adam_.launches)
    before = counts()
    losses, applied = [], 0
    for _ in range(3):
        with paddle.amp.auto_cast(level=level, dtype=amp_dtype):
            loss = F.cross_entropy(clf(x), y)
        scaler.scale(loss).backward()
        if level == "O1":
            assert all(p.grad.dtype == torch.float32
                       for p in clf.parameters())
        scaler.step(opt)
        applied += not scaler.last_step_skipped()
        opt.clear_grad()
        losses.append(float(loss))
    got = [a - b for a, b in zip(counts(), before)]
    assert seen and set(seen) == {dt}
    assert got == [6, 6, 6, 3 * 5, applied] and applied >= 1
    want = dt if level == "O2" else torch.float32
    assert {p.dtype for p in clf.parameters()} == {want}
    assert all(np.isfinite(losses))


# f32: sums over up to 4096 rows in another order; bf16: one rounding
# step of the output (2^-7 relative) plus that
BN_F32 = dict(atol=1e-4, rtol=1e-4)
BN_BF16 = dict(atol=2e-2, rtol=2 ** -7)


def _bn(dev, rows, c, dtype, seed=0):
    g_ = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g_)  # noqa
    x = (rnd(rows, c) * 1.5 + 0.3).to(dtype)
    return (x, rnd(c).to(dtype), rnd(c).to(dtype), rnd(rows, c).to(dtype),
            rnd(c) * 0.2, rnd(c).abs() + 0.5, rnd(rows, c).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("use_res", [False, True])
@pytest.mark.parametrize("rows,c", [(4096, 64), (98, 2048)])
def test_fused_bn_kernels_match_their_plain_versions(dev, dtype, act,
                                                      use_res, rows, c):
    x, g, b, res, m, v, dy = _bn(dev, rows, c, dtype)
    r = res if use_res else None
    tol = BN_F32 if dtype == torch.float32 else BN_BF16
    close = lambda a, b_: torch.testing.assert_close(  # noqa: E731
        a.float(), b_.float(), **tol)
    before = (fbn.fused_bn_train.launches, fbn.fused_bn_norm.launches,
              fbb.train_bwd.launches, fbb.norm_bwd.launches)
    y, mean, var = fbn._train_fwd(x, g, b, r, 1e-5, act)
    ry, rmean, rvar = fbn.fused_bn_train_ref(x, g, b, 1e-5, act, r)
    close(y, ry)
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(var, rvar, atol=1e-5, rtol=1e-4)
    got = fbb.train_bwd(x, g, mean, var, y, dy, 1e-5, act, use_res)
    want = fbb.train_bwd_ref(x, g, mean, var, y, dy, 1e-5, act, use_res)
    for a, b_ in zip(got, want):
        close(a, b_)
    yn = fbn._norm_fwd(x, m, v, g, b, r, 1e-5, act)
    close(yn, fbn.fused_bn_norm_ref(x, m, v, g, b, 1e-5, act, r))
    got = fbb.norm_bwd(x, g, m, v, yn, dy, 1e-5, act, use_res)
    want = fbb.norm_bwd_ref(x, g, m, v, yn, dy, 1e-5, act, use_res)
    for a, b_ in zip(got, want):
        close(a, b_)
    assert (fbn.fused_bn_train.launches, fbn.fused_bn_norm.launches,
            fbb.train_bwd.launches, fbb.norm_bwd.launches) == tuple(
                n + 1 for n in before)
    # the reductions are deterministic: a repeat is bit-identical
    assert torch.equal(fbn._train_fwd(x, g, b, r, 1e-5, act)[1], mean)


# ResNet-50's layer 4 and layer 3 at 32 images (whole chunks in shared
# memory) and the stem's width at a row count whose chunks are only partly
# resident
BN_REDESIGNED = [(1568, 2048), (6272, 1024), (200000, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("use_res", [False, True])
@pytest.mark.parametrize("rows,c", BN_REDESIGNED)
def test_bn_train_backward_and_norm_forward_match_and_repeat(dev, dtype, act,
                                                             use_res, rows,
                                                             c):
    x, g, b, res, m, v, dy = _bn(dev, rows, c, dtype)
    r = res if use_res else None
    tol = BN_F32 if dtype == torch.float32 else BN_BF16
    close = lambda a, b_: torch.testing.assert_close(  # noqa: E731
        a.float(), b_.float(), **tol)
    plan = fbb.train_bwd_launch_plan(x, 1 if dtype == torch.bfloat16 else 0)
    if rows == 200000:
        assert 0 < plan.resident < plan.rows_per_chunk
    elif dtype == torch.bfloat16:   # the main path's: whole chunks held
        assert plan.resident == plan.rows_per_chunk
    y, mean, var = fbn.fused_bn_train_ref(x, g, b, 1e-5, act, r)
    got = fbb.train_bwd(x, g, mean, var, y, dy, 1e-5, act, use_res)
    want = fbb.train_bwd_ref(x, g, mean, var, y, dy, 1e-5, act, use_res)
    for a, b_ in zip(got, want):
        close(a, b_)
    again = fbb.train_bwd(x, g, mean, var, y, dy, 1e-5, act, use_res)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, got))
    yn = fbn._norm_fwd(x, m, v, g, b, r, 1e-5, act)
    close(yn, fbn.fused_bn_norm_ref(x, m, v, g, b, 1e-5, act, r))
    assert torch.equal(fbn._norm_fwd(x, m, v, g, b, r, 1e-5, act), yn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_backward_and_norm_forward_replay_in_a_cuda_graph(dev,
                                                                   dtype):
    x, g, b, _, m, v, dy = _bn(dev, 1568, 2048, dtype)
    run = lambda: (fbb.train_bwd(x, g, m, v, None, dy, 1e-5,  # noqa: E731
                                 "identity", True),
                   fbn._norm_fwd(x, m, v, g, b, None, 1e-5, "relu"))
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_)
                   for a, b_ in zip(captured[0], eager[0]))
        assert torch.equal(captured[1], eager[1])


def test_a_refused_cooperative_launch_raises(dev, monkeypatch):
    x, g, _, _, m, v, dy = _bn(dev, 200000, 64, torch.bfloat16)
    sms, blocks, budget = fbb._train_limits(0, 1, 1)
    before = fbb.train_bwd.launches
    # more CTAs than the card holds at once
    monkeypatch.setattr(fbb, "_train_limits",
                        lambda *a: (4 * sms, blocks, budget))
    with pytest.raises(KernelLaunchError, match="p1t_fused_bn_bwd_train"):
        fbb.train_bwd(x, g, m, v, None, dy, 1e-5, "identity")
    # more shared memory a CTA than the card gives one
    monkeypatch.setattr(fbb, "_train_limits",
                        lambda *a: (sms, blocks, 300000))
    with pytest.raises(KernelLaunchError, match="p1t_fused_bn_bwd_train"):
        fbb.train_bwd(x, g, m, v, None, dy, 1e-5, "identity")
    monkeypatch.undo()
    assert fbb.train_bwd.launches == before
    # nothing is left behind: the next launch and torch's own run
    dx = fbb.train_bwd(x, g, m, v, None, dy, 1e-5, "identity")[0]
    assert bool(torch.isfinite((dx.float() * 2).sum()))


# ResNet-50's layer 4 and layer 2 at 32 images (whole chunks in shared
# memory in bf16) and the stem's width at a row count whose chunks are
# only partly resident
BN_FWD = [(1568, 2048), (25088, 512), (300000, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("use_res", [False, True])
@pytest.mark.parametrize("rows,c", BN_FWD)
def test_bn_train_forward_matches_and_repeats(dev, dtype, act, use_res,
                                              rows, c):
    x, g, b, res, _, _, _ = _bn(dev, rows, c, dtype)
    r = res if use_res else None
    tol = BN_F32 if dtype == torch.float32 else BN_BF16
    plan = fbn.train_fwd_launch_plan(x, 1 if dtype == torch.bfloat16 else 0)
    if rows == 300000:
        assert 0 < plan.resident < plan.rows_per_chunk
    elif dtype == torch.bfloat16:   # the main path's: whole chunks held
        assert plan.resident == plan.rows_per_chunk
    before = fbn.fused_bn_train.launches
    y, mean, var = fbn._train_fwd(x, g, b, r, 1e-5, act)
    assert fbn.fused_bn_train.launches == before + 1
    ry, rmean, rvar = fbn.fused_bn_train_ref(x, g, b, 1e-5, act, r)
    torch.testing.assert_close(y.float(), ry.float(), **tol)
    stat_tol = dict(atol=1e-5 * rows ** 0.5, rtol=1e-4)
    torch.testing.assert_close(mean, rmean, **stat_tol)
    torch.testing.assert_close(var, rvar, **stat_tol)
    again = fbn._train_fwd(x, g, b, r, 1e-5, act)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, (y, mean, var)))


@pytest.mark.parametrize("rows,c,dtype", [(401408, 64, torch.bfloat16),
                                          (32768, 64, torch.float32),
                                          (1568, 2048, torch.float32)])
def test_bn_train_forward_sums_in_the_reduction_pass_order(dev, rows, c,
                                                           dtype):
    # the statistics are the local-moments pass's sums (the same chunks,
    # in the same order), so the mean is its sum times 1 / rows, bit for
    # bit
    x, g, b, _, _, _, _ = _bn(dev, rows, c, dtype)
    s, _ = fbn._moments_fwd(x)
    _, mean, _ = fbn._train_fwd(x, g, b, None, 1e-5, "identity")
    assert torch.equal(mean, s * torch.tensor(1.0 / rows,
                                              dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_forward_replays_in_a_cuda_graph(dev, dtype):
    x, g, b, res, _, _, _ = _bn(dev, 6272, 1024, dtype)
    run = lambda: fbn._train_fwd(x, g, b, res, 1e-5, "relu")  # noqa: E731
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(captured, eager))


def test_a_refused_cooperative_forward_launch_raises(dev, monkeypatch):
    x, g, b, _, _, _, _ = _bn(dev, 300000, 64, torch.bfloat16)
    sms, blocks, budget = fbn._train_limits(0, 1, 1)
    before = fbn.fused_bn_train.launches
    # more CTAs than the card holds at once
    monkeypatch.setattr(fbn, "_train_limits",
                        lambda *a: (4 * sms, blocks, budget))
    with pytest.raises(KernelLaunchError, match="p1t_fused_bn_train_fwd"):
        fbn._train_fwd(x, g, b, None, 1e-5, "identity")
    # more shared memory a CTA than the card gives one
    monkeypatch.setattr(fbn, "_train_limits",
                        lambda *a: (sms, blocks, 300000))
    with pytest.raises(KernelLaunchError, match="p1t_fused_bn_train_fwd"):
        fbn._train_fwd(x, g, b, None, 1e-5, "identity")
    monkeypatch.undo()
    assert fbn.fused_bn_train.launches == before
    # nothing is left behind: the next launch and torch's own run
    y = fbn._train_fwd(x, g, b, None, 1e-5, "identity")[0]
    assert bool(torch.isfinite((y.float() * 2).sum()))


@pytest.mark.parametrize("case", ["channels", "dtype", "strided",
                                  "mixed_affine"])
def test_fused_bn_outside_the_contract_raises_on_the_card(dev, case):
    x, g, b, _, _, _, _ = _bn(dev, 64, 16, torch.float32)
    if case == "channels":
        x, g, b = x[:, :12].contiguous(), g[:12], b[:12]
    elif case == "dtype":
        x = x.double()       # f16 is inside the contract since F24
    elif case == "strided":
        x = torch.randn(16, 64, device=dev).t()      # [64, 16], not packed
    else:
        g = g.to(torch.bfloat16)
    with pytest.raises(InvalidArgumentError, match="contract"):
        fbn.fused_bn_train(x, g, b, 1e-5)


# an affine-less batch norm takes the kernels since F18 (ones and zeros for
# gamma and beta); outside the contract it still raises (f16 is inside it
# since F24, float64 is not)
@pytest.mark.parametrize("case", ["f64", "channels", "affine_less_channels",
                                  "channels_first"])
def test_batch_norm_outside_the_kernel_contract_raises_on_the_card(dev,
                                                                   case):
    from paddle1_tpu_torch.core.flags import flags_guard
    c = 12 if case in ("channels", "affine_less_channels") else 16
    x = torch.randn(4, c, 5, 5, device=dev,
                    dtype=torch.float64 if case == "f64" else torch.float32)
    w = None if case == "affine_less_channels" else \
        torch.ones(c, device=dev)
    b = None if case == "affine_less_channels" else \
        torch.zeros(c, device=dev)
    m, v = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    nhwc = "never" if case == "channels_first" else "auto"
    before = (fbn.fused_bn_train.launches, fbn.fused_bn_norm.launches)
    with flags_guard(conv_nhwc=nhwc):
        for training in (True, False):
            with pytest.raises(InvalidArgumentError, match="contract"):
                F.batch_norm(x, m, v, w, b, training=training)
        with flags_guard(fused_bn="never"):     # the plain composition
            y = F.batch_norm(x, m, v, w, b, training=True)
    assert y.shape == x.shape
    assert (fbn.fused_bn_train.launches, fbn.fused_bn_norm.launches) == \
        before


# float16 rows 8-12 (F24) against their plain versions: one f16 rounding
# step of the value (F16_REL) plus the f32 tolerance on rows; the
# statistics, the gamma/beta sums and the moments in f32 as for f32 data.
# ResNet-50's layer 2 and layer 4 shapes (whole chunks resident), YOLOv3's
# stride-8 shape, and the stem's width at a row count only partly resident
BN_F16_SHAPES = [(25088, 512), (1568, 2048), (46208, 256), (200000, 64)]


def _f16_rows_close(got, want):
    assert _bf16_excess(got, want, F16_REL + BN_F32["rtol"]) <= \
        BN_F32["atol"]


def _at_offset(t, elems):
    """``t`` copied into a view that starts ``elems`` elements into a
    larger buffer (16-byte aligned for 8 f16 elements, not 256-byte)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    v = buf[elems:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("pdtype", [torch.float16, torch.float32],
                         ids=["f16-params", "f32-params"])
@pytest.mark.parametrize("act,use_res", [("identity", False),
                                         ("relu", True)])
@pytest.mark.parametrize("rows,c", BN_F16_SHAPES)
@pytest.mark.parametrize("view", ["fresh", "offset"])
def test_f16_bn_kernels_match_their_plain_versions(dev, pdtype, act,
                                                   use_res, rows, c, view):
    x, g, b, res, m, v, dy = _bn(dev, rows, c, torch.float16)
    g, b = g.to(pdtype), b.to(pdtype)
    if view == "offset":
        x, res, dy = (_at_offset(t, 8) for t in (x, res, dy))
        assert x.data_ptr() % 256 and x.data_ptr() % 16 == 0
    r = res if use_res else None
    stat_tol = dict(atol=1e-5 * rows ** 0.5, rtol=1e-4)
    before = (fbn.fused_bn_train.launches, fbn.fused_bn_norm.launches,
              fbn.local_moments.launches, fbb.train_bwd.launches,
              fbb.norm_bwd.launches)
    y, mean, var = fbn._train_fwd(x, g, b, r, 1e-5, act)
    ry, rmean, rvar = fbn.fused_bn_train_ref(x, g, b, 1e-5, act, r)
    assert y.dtype == torch.float16
    _f16_rows_close(y, ry)
    torch.testing.assert_close(mean, rmean, **stat_tol)
    torch.testing.assert_close(var, rvar, **stat_tol)
    got = fbb.train_bwd(x, g, mean, var, y, dy, 1e-5, act, use_res)
    want = fbb.train_bwd_ref(x, g, mean, var, y, dy, 1e-5, act, use_res)
    _f16_rows_close(got[0], want[0])
    for a, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(a, w, **_sum_tol(rows))
    if use_res:
        assert torch.equal(got[3], want[3])       # the masked dy
    yn = fbn._norm_fwd(x, m, v, g, b, r, 1e-5, act)
    _f16_rows_close(yn, fbn.fused_bn_norm_ref(x, m, v, g, b, 1e-5, act, r))
    got = fbb.norm_bwd(x, g, m, v, yn, dy, 1e-5, act, use_res)
    want = fbb.norm_bwd_ref(x, g, m, v, yn, dy, 1e-5, act, use_res)
    _f16_rows_close(got[0], want[0])
    for a, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(a, w, **_sum_tol(rows))
    s, ss = fbn._moments_fwd(x)
    rs, rss = fbn.local_moments_ref(x)
    torch.testing.assert_close(s, rs, **_sum_tol(rows))
    torch.testing.assert_close(ss, rss, **_sum_tol(rows))
    assert (fbn.fused_bn_train.launches, fbn.fused_bn_norm.launches,
            fbn.local_moments.launches, fbb.train_bwd.launches,
            fbb.norm_bwd.launches) == tuple(n + 1 for n in before)
    # the reductions are deterministic: repeats are bit-identical
    again = fbn._train_fwd(x, g, b, r, 1e-5, act)
    assert all(torch.equal(a, w) for a, w in zip(again, (y, mean, var)))
    assert torch.equal(fbn._moments_fwd(x)[0], s)


def test_f16_bn_kernels_at_a_misaligned_view_raise(dev):
    x, g, b, _, _, _, _ = _bn(dev, 64, 16, torch.float16)
    x = _at_offset(x, 1)          # 2 bytes off a 16-byte boundary
    for call in (lambda: fbn.fused_bn_train(x, g, b, 1e-5),
                 lambda: fbn.local_moments(x)):
        with pytest.raises(InvalidArgumentError, match="contract"):
            call()


def test_f16_engine_resnet_step_launches_the_bn_kernels(dev):
    """F24 on the card: a tiny ResNet-18 under ``ParallelEngine(
    amp_dtype="float16")`` runs every batch norm on rows 8 and 11 in f16
    (20 batch norms a step), losses finite."""
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet18
    torch.manual_seed(0)
    m = resnet18(num_classes=10, device=dev)
    eng = ParallelEngine(m, Momentum(learning_rate=1e-3, momentum=0.9,
                                     parameters=m.parameters()),
                         lambda mm, bb: F.cross_entropy(mm(bb["x"]),
                                                        bb["y"]),
                         amp_dtype="float16")
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
             "y": rng.integers(0, 10, (4,)).astype(np.int64)}
    before = (fbn.fused_bn_train.launches, fbb.train_bwd.launches)
    losses = [float(eng.step(batch)) for _ in range(2)]
    assert (fbn.fused_bn_train.launches - before[0],
            fbb.train_bwd.launches - before[1]) == (40, 40)
    assert all(np.isfinite(losses))
    assert {p.dtype for p in m.parameters()} == {torch.float32}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f18_affine_less_batch_norm_runs_the_kernels(dev, dtype):
    """F18: ``BatchNorm2D(weight_attr=False, bias_attr=False)`` trains,
    backpropagates and evaluates on the kernels (gamma ones and beta
    zeros) where it raised, and agrees with the plain composition."""
    from paddle1_tpu_torch.core.flags import flags_guard
    from paddle1_tpu_torch.nn import BatchNorm2D, BatchNorm1D
    c = 24
    tol = BN_F32 if dtype == torch.float32 else BN_BF16
    g_ = torch.Generator(device=dev).manual_seed(3)
    x0 = (torch.randn(8, c, 14, 14, device=dev, generator=g_) * 2 +
          0.5).to(dtype)
    dy = torch.randn(8, c, 14, 14, device=dev, generator=g_).to(dtype)
    runs = {}
    for flag in ("auto", "never"):
        # the plain composition in f32 on the same (rounded) inputs: in
        # bf16 it would round after each of its ops, the kernel once
        run_dtype = dtype if flag == "auto" else torch.float32
        bn = BatchNorm2D(c, weight_attr=False, bias_attr=False, device=dev)
        assert bn.weight is None and bn.bias is None
        bn.to(dtype=run_dtype)
        x = x0.detach().to(run_dtype).clone().requires_grad_()
        before = (fbn.fused_bn_train.launches, fbb.train_bwd.launches,
                  fbn.fused_bn_norm.launches)
        with flags_guard(fused_bn=flag, fused_bn_bwd=flag):
            y = bn(x)
            (y.float() * dy.float()).sum().backward()
            bn.eval()
            with torch.no_grad():
                ye = bn(x0.to(run_dtype))
        after = (fbn.fused_bn_train.launches, fbb.train_bwd.launches,
                 fbn.fused_bn_norm.launches)
        assert [a - b for a, b in zip(after, before)] == \
            ([1, 1, 1] if flag == "auto" else [0, 0, 0])
        runs[flag] = (y, x.grad, ye, bn._mean, bn._variance)
    for got, want in zip(runs["auto"], runs["never"]):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    # BatchNorm1D's [N, C, L] goes through the 3-D channels-last permute
    bn1 = BatchNorm1D(c, weight_attr=False, bias_attr=False, device=dev)
    x1 = torch.randn(8, c, 50, device=dev)
    before = fbn.fused_bn_train.launches
    y1 = bn1(x1)
    assert fbn.fused_bn_train.launches == before + 1
    with flags_guard(fused_bn="never"):
        want = bn1(x1)
    torch.testing.assert_close(y1, want, **BN_F32)


# MobileNetV2's batch-norm shapes at batch 96 x 224² (52 batch norms at 19
# (rows, C) pairs: C 16-1280, rows 96 * 112² down to 96 * 7²)
MOBILENET_BN = [(1204224, 32), (1204224, 16), (1204224, 96), (301056, 96),
                (301056, 24), (301056, 144), (75264, 144), (75264, 32),
                (75264, 192), (18816, 192), (18816, 64), (18816, 384),
                (18816, 96), (18816, 576), (4704, 576), (4704, 160),
                (4704, 960), (4704, 320), (4704, 1280)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", MOBILENET_BN)
def test_bn_kernels_at_mobilenet_v2_shapes(dev, dtype, rows, c):
    """Rows 8, 9 and 11 at every shape MobileNetV2 gives them (channel
    tiles of 2-32 vectors, partial last tiles at C = 320-1280): each
    against its plain version, repeats bit for bit."""
    x, g, b, _, m, v, dy = _bn(dev, rows, c, dtype)
    tol = BN_F32 if dtype == torch.float32 else BN_BF16
    close = lambda a, b_: torch.testing.assert_close(  # noqa: E731
        a.float(), b_.float(), **tol)
    y, mean, var = fbn._train_fwd(x, g, b, None, 1e-5, "identity")
    ry, rmean, rvar = fbn.fused_bn_train_ref(x, g, b, 1e-5, "identity")
    close(y, ry)
    stat_tol = dict(atol=1e-5 * rows ** 0.5, rtol=1e-4)
    torch.testing.assert_close(mean, rmean, **stat_tol)
    torch.testing.assert_close(var, rvar, **stat_tol)
    got = fbb.train_bwd(x, g, mean, var, y, dy, 1e-5, "identity")
    want = fbb.train_bwd_ref(x, g, mean, var, y, dy, 1e-5, "identity")
    close(got[0], want[0])
    for a, b_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b_, **stat_tol)
    yn = fbn._norm_fwd(x, m, v, g, b, None, 1e-5, "identity")
    close(yn, fbn.fused_bn_norm_ref(x, m, v, g, b, 1e-5, "identity"))
    again = fbn._train_fwd(x, g, b, None, 1e-5, "identity")
    assert all(torch.equal(a, b_) for a, b_ in zip(again, (y, mean, var)))
    assert all(torch.equal(a, b_) for a, b_ in zip(
        fbb.train_bwd(x, g, mean, var, y, dy, 1e-5, "identity"), got))


def test_mobilenet_v2_eager_steps_launch_every_bn_kernel(dev):
    """A narrow MobileNetV2 (scale 0.25) at 4 x 3 x 32², eager Momentum
    steps: one row-8 and one row-11 launch per batch norm a step, one
    row-9 launch per batch norm an eval forward; the loss finite."""
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch import nn
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import mobilenet_v2
    torch.manual_seed(0)
    m = mobilenet_v2(scale=0.25, num_classes=10)
    opt = Momentum(0.045, 0.9, parameters=m.parameters(),
                   weight_decay=paddle.regularizer.L2Decay(4e-5))
    crit = nn.CrossEntropyLoss()
    rng = np.random.default_rng(0)
    x = paddle.to_tensor(rng.standard_normal((4, 3, 32, 32)).astype(
        np.float32))
    y = paddle.to_tensor(rng.integers(0, 10, (4,)))
    counts = lambda: np.array([fbn.fused_bn_train.launches,  # noqa: E731
                               fbb.train_bwd.launches,
                               fbn.fused_bn_norm.launches])
    c0 = counts()
    losses = []
    for _ in range(3):
        loss = crit(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    c1 = counts()
    m.eval()
    with paddle.no_grad():
        out = m(x)
    c2 = counts()
    assert list(c1 - c0) == [3 * 52, 3 * 52, 0]
    assert list(c2 - c1) == [0, 0, 52]
    assert all(np.isfinite(losses))
    assert out.shape == [4, 10] and bool(torch.isfinite(out).all())


def test_tiny_resnet_steps_launch_every_bn_kernel(dev):
    from paddle1_tpu_torch.distributed import ParallelEngine
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet18
    torch.manual_seed(0)
    m = resnet18(num_classes=10)
    eng = ParallelEngine(m, Momentum(learning_rate=1e-3,
                                     parameters=m.parameters()),
                         lambda mm, b: F.cross_entropy(mm(b["x"]), b["y"]),
                         amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
             "y": rng.integers(0, 10, (4,))}
    counts = lambda: np.array([fbn.fused_bn_train.launches,  # noqa: E731
                               fbb.train_bwd.launches,
                               fbn.fused_bn_norm.launches,
                               fbb.norm_bwd.launches])
    c0 = counts()
    losses = [float(eng.step(batch)) for _ in range(3)]
    c1 = counts()
    m.eval()
    with torch.no_grad():
        out = m(torch.from_numpy(batch["x"]).to(dev))
    c2 = counts()
    m.train()
    for mod in m.modules():
        if hasattr(mod, "_use_global_stats"):
            mod._use_global_stats = True
    frozen = float(eng.step(batch))
    c3 = counts()
    # ResNet-18 has 20 batch norms
    assert list(c1 - c0) == [60, 60, 0, 0]
    assert list(c2 - c1) == [0, 0, 20, 0]
    assert list(c3 - c2) == [0, 0, 20, 20]
    assert all(np.isfinite(losses + [frozen])) and losses[-1] < losses[0]
    assert out.shape == (4, 10) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(4096, 64), (98, 2048), (401408, 64)])
def test_local_moments_kernel_matches_its_plain_version(dev, dtype, rows, c):
    x = _bn(dev, rows, c, dtype)[0]
    before = fbn.local_moments.launches
    s, ss = fbn._moments_fwd(x)
    rs, rss = fbn.local_moments_ref(x)
    assert fbn.local_moments.launches == before + 1
    assert s.dtype == ss.dtype == torch.float32
    # f32 sums over up to 4e5 rows in another order: relative 1e-4 with a
    # floor of 1e-5 * sqrt(rows) for sums that cancel to near zero
    floor = 1e-5 * rows ** 0.5
    torch.testing.assert_close(s, rs, atol=floor, rtol=1e-4)
    torch.testing.assert_close(ss, rss, atol=floor, rtol=1e-4)
    again = fbn._moments_fwd(x)
    assert torch.equal(again[0], s) and torch.equal(again[1], ss)
    xg = x.detach().clone().requires_grad_()
    ds = torch.randn(c, device=dev)
    dss = torch.randn(c, device=dev)
    dx, = torch.autograd.grad(fbn.local_moments(xg), xg, (ds, dss))
    want = (ds[None] + 2.0 * x.float() * dss[None]).to(dtype)
    assert dx.dtype == dtype and torch.equal(dx, want)


# the one-launch reductions: ResNet-50's stem and layers 2-4 at 32 images
# (528, 262, 131 and 66 chunks a channel tile), one chunk a tile, and a
# short ragged shape with 8 tiles
BN_REDUCE = [(401408, 64), (25088, 512), (6272, 1024), (1568, 2048),
             (7, 64), (98, 2048)]


def _sum_tol(rows):
    # f32 sums over `rows` rows in another order: relative 1e-4 with a
    # floor of 1e-5 * sqrt(rows) for sums that cancel to near zero
    return dict(atol=1e-5 * rows ** 0.5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", BN_REDUCE)
def test_local_moments_is_one_launch_that_matches_and_repeats(dev, dtype,
                                                              rows, c):
    x = _bn(dev, rows, c, dtype)[0]
    before = fbn.local_moments.launches
    s, ss = fbn._moments_fwd(x)
    assert fbn.local_moments.launches == before + 1
    rs, rss = fbn.local_moments_ref(x)
    torch.testing.assert_close(s, rs, **_sum_tol(rows))
    torch.testing.assert_close(ss, rss, **_sum_tol(rows))
    for _ in range(2):
        again = fbn._moments_fwd(x)
        assert torch.equal(again[0], s) and torch.equal(again[1], ss)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", BN_REDUCE)
def test_norm_backward_is_one_launch_that_matches_and_repeats(dev, dtype,
                                                              rows, c):
    x, g, b, res, m, v, dy = _bn(dev, rows, c, dtype)
    tol = BN_F32 if dtype == torch.float32 else BN_BF16
    yn = fbn._norm_fwd(x, m, v, g, b, res, 1e-5, "relu")
    for act in ("identity", "relu"):
        for use_res in (False, True):
            before = fbb.norm_bwd.launches
            got = fbb.norm_bwd(x, g, m, v, yn, dy, 1e-5, act, use_res)
            assert fbb.norm_bwd.launches == before + 1
            want = fbb.norm_bwd_ref(x, g, m, v, yn, dy, 1e-5, act, use_res)
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       **tol)
            if use_res:
                assert torch.equal(got[3], want[3])   # the masked dy
            for a, w in zip(got[1:3], want[1:3]):
                torch.testing.assert_close(a, w, **_sum_tol(rows))
            again = fbb.norm_bwd(x, g, m, v, yn, dy, 1e-5, act, use_res)
            assert all(torch.equal(a, w) for a, w in zip(again, got))


def test_one_launch_reductions_launch_one_kernel_each(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, g, _, _, m, v, dy = _bn(dev, 6272, 1024, torch.bfloat16)
    calls = {"moments_kernel": lambda: fbn._moments_fwd(x),
             "norm_bwd_kernel": lambda: fbb.norm_bwd(
                 x, g, m, v, None, dy, 1e-5, "identity")}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA and
                   not getattr(e, "is_user_annotation", False)]
        assert len(kernels) == 1 and name in kernels[0], kernels


def test_one_launch_reductions_replay_in_a_cuda_graph(dev):
    # the dp step's pattern: moments and given-statistics backward calls
    # back to back on one stream, on the same counters (one channel tile
    # at C = 256), 53 in all
    sets = [_bn(dev, 6272, 256, torch.bfloat16, seed=i) for i in range(4)]

    def run():
        out = []
        for i in range(53):
            x, g, _, _, m, v, dy = sets[(i // 2) % 4]
            out += fbn._moments_fwd(x) if i % 2 == 0 else fbb.norm_bwd(
                x, g, m, v, None, dy, 1e-5, "identity", True)
        return out
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, w) for a, w in zip(captured, eager))
    # the counters are back at 0: an eager run after the replays
    assert all(torch.equal(a, w) for a, w in zip(run(), eager))


@pytest.mark.parametrize("which", ["moments", "norm_bwd"])
def test_one_launch_reductions_first_call_inside_a_capture_raises(
        dev, monkeypatch, which):
    # their ticket counters must exist before a graph captures a launch
    x, g, _, _, m, v, dy = _bn(dev, 1568, 512, torch.float32)
    monkeypatch.setattr(fbn, "_counters", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(KernelLaunchError, match="outside CUDA-graph"):
        with torch.cuda.graph(graph):
            if which == "moments":
                fbn._moments_fwd(x)
            else:
                fbb.norm_bwd(x, g, m, v, None, dy, 1e-5, "identity")


@pytest.mark.parametrize("case", ["channels", "dtype", "strided"])
def test_local_moments_outside_the_contract_raises_on_the_card(dev, case):
    x = _bn(dev, 64, 16, torch.float32)[0]
    if case == "channels":
        x = x[:, :12].contiguous()
    elif case == "dtype":
        x = x.double()       # f16 is inside the contract since F24
    else:
        x = torch.randn(16, 64, device=dev).t()
    with pytest.raises(InvalidArgumentError, match="contract"):
        fbn.local_moments(x)


def test_tiny_resnet_dp_step_launches_the_moments_kernel(dev):
    from paddle1_tpu_torch.distributed import ParallelEngine, build_mesh
    from paddle1_tpu_torch.optimizer import Momentum
    from paddle1_tpu_torch.vision.models import resnet18
    torch.manual_seed(0)
    m = resnet18(num_classes=10)
    eng = ParallelEngine(m, Momentum(learning_rate=1e-3,
                                     parameters=m.parameters()),
                         lambda mm, b: F.cross_entropy(mm(b["x"]), b["y"]),
                         mesh=build_mesh(dp=1), amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = eng.shard_batch({
        "x": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
        "y": rng.integers(0, 10, (4,))})
    counts = lambda: np.array([fbn.local_moments.launches,  # noqa: E731
                               fbn.fused_bn_norm.launches,
                               fbb.norm_bwd.launches,
                               fbn.fused_bn_train.launches,
                               fbb.train_bwd.launches])
    c0 = counts()
    losses = [float(eng.step(batch)) for _ in range(3)]
    # ResNet-18 has 20 batch norms, each on the cross-rank arm
    assert list(counts() - c0) == [60, 60, 60, 0, 0]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,h", [(64, 10), (32, 1000), (100, 1003),
                                    (96, 128), (7, 1024), (16, 1025),
                                    (8, 4096), (4, 32000), (3, 30522)])
def test_softmax_kernel_matches_its_plain_version(dev, dtype, rows, h):
    g = torch.Generator(device=dev).manual_seed(rows * h)
    x = (torch.randn(rows, h, device=dev, generator=g) * 4).to(dtype)
    x[0, : h // 2] = -float("inf")          # masked entries give 0
    before = psm.fused_softmax.launches
    y = psm.softmax_fwd(x)
    want = psm.softmax_ref(x)
    torch.cuda.synchronize()
    assert psm.fused_softmax.launches == before + 1
    assert y.dtype == dtype and torch.isfinite(y).all()
    err = (y.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-6
    else:   # one rounding step of the output dtype
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        assert float((err - rel * want.float().abs()).max()) <= 1e-5
    assert torch.equal(psm.softmax_fwd(x), y)     # repeats bit-identical
    assert float(y[0, : h // 2].abs().max()) == 0.0


def test_softmax_kernel_gradient_matches_plain_autograd(dev):
    x = torch.randn(64, 1000, device=dev, requires_grad=True)
    dy = torch.randn(64, 1000, device=dev)
    psm.fused_softmax(x).backward(dy)
    xr = x.detach().clone().requires_grad_(True)
    psm.softmax_ref(xr).backward(dy)
    assert float((x.grad - xr.grad).abs().max()) <= 1e-6


@pytest.mark.parametrize("case", ["int32", "f64", "1-d"])
def test_softmax_outside_the_contract_raises_on_the_card(dev, case):
    x = {"int32": torch.ones(4, 8, device=dev, dtype=torch.int32),
         "f64": torch.randn(4, 8, device=dev, dtype=torch.float64),
         "1-d": torch.randn(8, device=dev)}[case]
    with pytest.raises(InvalidArgumentError, match="contract"):
        psm.fused_softmax(x)


def test_functional_softmax_on_the_card_launches_the_kernel(dev):
    x = torch.randn(64, 10, device=dev)
    before = psm.fused_softmax.launches
    y = F.softmax(x)
    assert psm.fused_softmax.launches == before + 1
    F.softmax(x, axis=0)                           # not the last axis
    assert psm.fused_softmax.launches == before + 1
    assert float((y.sum(-1) - 1).abs().max()) <= 1e-6
    # routed by shape and axis alone, as the JAX package: f16 launches the
    # kernel, and a dtype the kernel lacks raises instead of leaving it
    assert F.softmax(x.half()).dtype == torch.float16
    assert psm.fused_softmax.launches == before + 2
    with pytest.raises(InvalidArgumentError, match="contract"):
        F.softmax(x.double())


# every path of the kernel: lane groups of 1 to 32 lanes, a block a row
# from shared memory (up to the on-chip limit) and the two-pass rows past
# it, at widths whose rows start off a 16-byte boundary too; 384, 640,
# 768 and 896 give lane groups of 32 lanes 3, 5, 6 and 7 vectors a lane
# in f32 (2, 3, 3, 4 in bf16 / f16)
SM_WIDTHS = [1, 3, 10, 127, 128, 129, 384, 640, 768, 896, 1003, 1024, 1025,
             30522, 32000, psm.WIDE_MAX, psm.WIDE_MAX + 1]


def _sm_view(dev, rows, h, dtype, offset, seed):
    """A seeded [rows, h] view starting ``offset`` elements into its
    storage (an odd offset: a data_ptr off a 16-byte boundary)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = (torch.randn(rows * h + offset, device=dev, generator=g) *
            4).to(dtype)
    return base[offset:].view(rows, h)


def _sm_excess(y, want):
    """Error beyond the tolerance: 1e-6 abs in f32, one rounding step of
    the output dtype in bf16 / f16 (chip_smoke.py's SM_TOL, BF16_REL)."""
    err = (y.float() - want.float()).abs()
    if y.dtype == torch.float32:
        return float(err.max()) - 1e-6
    rel = 2.0 ** -7 if y.dtype == torch.bfloat16 else 2.0 ** -10
    return float((err - rel * want.float().abs()).max()) - 1e-5


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", SM_WIDTHS)
def test_softmax_every_path_matches_its_plain_version(dev, h, dtype,
                                                      offset):
    # enough rows of a short width that its lane group keeps the header's
    # width (few rows spread over more lanes: the next test)
    rows = 65536 if h <= 64 else (37 if h > psm.NARROW_MAX else 301)
    x = _sm_view(dev, rows, h, dtype, offset, h + offset)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    x[2, : h // 2] = -float("inf")                # masked entries give 0
    before = psm.fused_softmax.launches
    y = psm.softmax_fwd(x)
    want = psm.softmax_ref(x)
    torch.cuda.synchronize()
    assert psm.fused_softmax.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    assert bool(torch.isfinite(y).all())
    assert _sm_excess(y, want) <= 0
    if h > 1:
        assert float(y[2, : h // 2].abs().max()) == 0.0
    assert torch.equal(psm.softmax_fwd(x), y)     # repeats bit-identical


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,h", [(64, 10), (5, 3), (64, 64), (64, 65),
                                    (2, 1000)])
def test_softmax_few_rows_spread_over_a_warp(dev, rows, h, dtype, offset):
    """LeNet's prediction and other launches too short to fill the card:
    a warp a row, an element a lane up to SCALAR_MAX, vectors above."""
    p = psm.plan(rows, h, torch.tensor([], dtype=dtype).element_size())
    assert (p.group, p.vec == 1) == (32, h <= psm.SCALAR_MAX)
    x = _sm_view(dev, rows, h, dtype, offset, rows + h)
    before = psm.fused_softmax.launches
    y = psm.softmax_fwd(x)
    torch.cuda.synchronize()
    assert psm.fused_softmax.launches == before + 1
    assert _sm_excess(y, psm.softmax_ref(x)) <= 0
    assert torch.equal(psm.softmax_fwd(x), y)


@pytest.mark.parametrize("h", [10, 128, 1003, 30522, psm.WIDE_MAX + 1])
def test_softmax_inf_rows_on_every_path(dev, h):
    """An all -inf row is NaN, a +inf entry makes its row NaN, a row
    masked but for one entry puts 1 there; the other rows are untouched
    by their neighbours, as the plain version has them."""
    x = _sm_view(dev, 9, h, torch.float32, 1, h)
    x[1] = -float("inf")
    x[4, h // 2] = float("inf")
    x[6] = -float("inf")
    x[6, h - 1] = 2.0
    y = psm.softmax_fwd(x)
    want = psm.softmax_ref(x)
    torch.cuda.synchronize()
    assert bool(torch.isnan(y[1]).all()) and bool(torch.isnan(y[4]).all())
    assert float(y[6, h - 1]) == 1.0 and float(y[6, : h - 1].abs().sum()) == 0
    keep = [0, 2, 3, 5, 6, 7, 8]
    assert _sm_excess(y[keep], want[keep]) <= 0


def test_softmax_refused_plans_raise(dev, monkeypatch):
    """A plan the kernel lacks, and a ring of shared buffers larger than a
    block can hold, come back as a CUDA error the wrapper raises; the
    counter does not move and the next call runs."""
    x = _sm_view(dev, 8, 4096, torch.float32, 0, 3)
    before = psm.fused_softmax.launches
    good = psm.plan
    monkeypatch.setattr(psm, "plan", lambda *a: good(*a)._replace(group=3))
    with pytest.raises(KernelLaunchError, match="softmax"):
        psm.softmax_fwd(x[:, :100])
    monkeypatch.setattr(psm, "plan", lambda *a: good(*a)._replace(
        nbuf=2, buf_bytes=131072))
    with pytest.raises(KernelLaunchError, match="softmax"):
        psm.softmax_fwd(x)
    monkeypatch.undo()
    assert psm.fused_softmax.launches == before
    assert _sm_excess(psm.softmax_fwd(x), psm.softmax_ref(x)) <= 0


def test_softmax_replays_in_a_cuda_graph(dev):
    xs = [_sm_view(dev, 64, h, torch.bfloat16, 1, h) for h in
          (10, 128, 32000, psm.WIDE_MAX + 1)]
    eager = [psm.softmax_fwd(x) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        [psm.softmax_fwd(x) for x in xs]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [psm.softmax_fwd(x) for x in xs]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_functional_softmax_promotes_integers_onto_the_kernel(dev, dtype):
    x = torch.arange(6, device=dev, dtype=dtype).reshape(2, 3)
    before = psm.fused_softmax.launches
    y = F.softmax(x)
    assert psm.fused_softmax.launches == before + 1
    assert y.dtype == torch.float32
    assert _sm_excess(y, psm.softmax_ref(x.float())) <= 0
    assert F.log_softmax(x).dtype == torch.float32
    assert psm.fused_softmax.launches == before + 1


def test_eager_lenet_runs_on_the_card(dev):
    import paddle1_tpu_torch as paddle
    from paddle1_tpu_torch.vision.models import LeNet
    paddle.seed(0)
    m = LeNet()
    assert all(p.device.type == "cuda" and isinstance(p, paddle.Parameter)
               for p in m.parameters())
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=m.parameters())
    rng = np.random.default_rng(0)
    x = paddle.to_tensor(rng.standard_normal((16, 1, 28, 28)).astype(
        np.float32))
    y = paddle.to_tensor(rng.integers(0, 10, (16,)))
    assert x.place == paddle.CUDAPlace(dev.index or 0)
    before = fad.fused_adam_.launches
    losses = []
    for _ in range(3):
        loss = F.cross_entropy(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    assert fad.fused_adam_.launches == before + 3
    assert losses[-1] < losses[0]
    with paddle.no_grad():
        sm = psm.fused_softmax.launches
        probs = F.softmax(m(x))
        assert psm.fused_softmax.launches == sm + 1
    p = probs.numpy()
    assert isinstance(probs, paddle.Tensor) and p.shape == (16, 10)
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=1e-5)


def _flash_bf16_hold(dev, b, nq, nk, seed):
    """Rows 3-5 on ``[b, nq, 8, 64]`` queries against ``[b, nk, 8, 64]``
    keys and values, bf16, a ragged keep-mask (lengths in (nk / 2, nk]):
    within one bf16 rounding step of their plain versions and repeated
    bit for bit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, nq, 8, 64, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, nk, 8, 64, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    lens = torch.from_numpy(np.random.default_rng(seed).integers(
        nk // 2 + 1, nk + 1, b))
    keep = (torch.arange(nk)[None, :] < lens[:, None]).to(dev)
    scale = 64 ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, False, keep)
    ro, rl = fa.flash_attention_ref(q, k, v, scale, False, keep)
    assert _bf16_excess(out, ro) <= FLASH_BF16_ABS
    assert float((lse - rl).abs().max()) <= FLASH_TOL
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, False, keep)
    dq = fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, False, keep)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, ro, rl, do, scale, False, keep)
    for got, want in ((dk, rk), (dv, rv), (dq, rq)):
        assert _bf16_excess(got, want) <= FLASH_BF16_ABS
    assert torch.equal(fa.flash_fwd(q, k, v, scale, False, keep)[0], out)
    assert torch.equal(fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, False,
                                       keep), dq)


def test_cross_attention_flash_at_the_transformer_shape(dev):
    """Rows 3-5 at Transformer-base's cross-attention: the target's 128
    queries against a 256-token source, ``[16, N, 8, 64]`` bf16, a ragged
    keep-mask; within one bf16 rounding step of their plain versions and
    repeated bit for bit."""
    _flash_bf16_hold(dev, 16, 128, 256, 21)


@pytest.mark.parametrize("b,n", [(32, 128), (16, 256)],
                         ids=["bucket128", "bucket256"])
def test_self_attention_flash_at_the_transformer_bucket_shapes(dev, b, n):
    """Rows 3-5 at Transformer-base's encoder self-attention in each token
    bucket, ``[b, n, 8, 64]`` bf16 with a ragged keep-mask, as at the
    cross-attention shape."""
    _flash_bf16_hold(dev, b, n, n, 22)


def test_transformer_steps_and_beam_search_launch_the_kernels(dev):
    """A narrow ``nn.Transformer`` (2 + 2 layers) through the translation
    script of ``chip_smoke.py`` under ``amp.auto_cast``: each step
    launches rows 3, 4 and 5 once per encoder self-attention and
    cross-attention, row 2 once per LayerNorm and row 6 once; a beam
    search runs row 3 on the encoder only and row 2 on every decoder
    LayerNorm of every step."""
    import chip_smoke as cs
    import paddle1_tpu_torch as paddle
    paddle.seed(0)
    with paddle.utils.unique_name.guard():
        m = cs.s2s_model(paddle, vocab=300, d_model=64, nhead=2,
                         enc_layers=2, dec_layers=2, ffn=128)
    rng = np.random.default_rng(0)
    batches = [cs.s2s_batch(paddle, m, rng, 4, 256, 128, 300)]
    opt, sched = cs.s2s_optimizer(paddle, m, 64, 40)
    step = cs.s2s_step_fn(paddle, m, opt, sched, batches, vocab=300)
    counts = lambda: (fa.flash_fwd.launches, fb.flash_bwd_dkv.launches,  # noqa: E731
                      fb.flash_bwd_dq.launches, ln.fused_layer_norm.launches,
                      fad.fused_adam_.launches)
    before = counts()
    losses = [float(step()) for _ in range(3)]
    got = [a - b for a, b in zip(counts(), before)]
    assert got == [3 * 4, 3 * 4, 3 * 4, 3 * 10, 3]
    assert all(np.isfinite(losses))
    before = counts()
    ids = cs.s2s_decode(paddle, m, batches[0]["src"],
                        batches[0]["src_mask"], beam=2, max_step_num=3)
    n = ids.shape[1]
    got = [a - b for a, b in zip(counts(), before)]
    assert got == [2, 0, 0, 4 + 6 * n, 0]


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


# chip_smoke.ls_sm_shapes(): a training step's [128, 1, 50], a beam step's
# [320, 1, 48] (whole 16-byte vectors) and the limit's [320, 1, 50] (a
# scalar head and tail); tests/test_torch_seq2seq.py holds the two equal
LS_SM_SHAPES = [(128, 50), (320, 48), (320, 50)]


@pytest.mark.parametrize("rows,s", LS_SM_SHAPES)
def test_softmax_at_the_lstm_seq2seq_attention_shapes(dev, rows, s):
    """Row 7 at ``[rows, 1, s]`` f32 with ragged pads at -1e9: within 1e-6
    of its plain version, bit-equal on a repeat, the pads at 0, and
    ``F.softmax`` launching it once."""
    g = torch.Generator(device=dev).manual_seed(rows + s)
    x = torch.randn(rows, 1, s, device=dev, generator=g) * 4
    lens = torch.randint(5, s + 1, (rows,), device=dev, generator=g)
    pad = torch.arange(s, device=dev)[None, :] >= lens[:, None]
    x = x - 1e9 * pad[:, None, :].float()
    before = psm.fused_softmax.launches
    y = F.softmax(x)
    assert psm.fused_softmax.launches == before + 1
    assert float((y - psm.softmax_ref(x)).abs().max()) <= 1e-6
    assert torch.equal(psm.softmax_fwd(x), y)
    assert float(y[pad[:, None, :]].abs().max()) == 0.0


def test_lstm_seq2seq_steps_and_beam_search_launch_rows_6_and_7(dev):
    """A narrow model of ``chip_smoke.py``'s attention LSTM seq2seq: each
    training step launches row 7 once per decoder step (the batch's padded
    target length) and row 6 once; a beam search launches row 7 once a
    decode step at ``[B x beam, 1, S]`` and nothing else."""
    import chip_smoke as cs
    import paddle1_tpu_torch as paddle
    paddle.seed(0)
    with paddle.utils.unique_name.guard():
        m = cs.ls_model(paddle, 300, 200, 64, 2)
    rng = np.random.default_rng(0)
    batches = [cs.ls_batch(paddle, rng, 8, 300, 200, 5, 12)
               for _ in range(2)]
    step = cs.ls_step_fn(paddle, m, cs.ls_optimizer(paddle, m), batches)
    counts = lambda: (psm.fused_softmax.launches,  # noqa: E731
                      fad.fused_adam_.launches, ln.fused_layer_norm.launches,
                      fa.flash_fwd.launches)
    before = counts()
    losses = [float(step()) for _ in range(3)]
    got = [a - b for a, b in zip(counts(), before)]
    assert got == [sum(step.trail), 3, 0, 0]
    assert all(np.isfinite(losses))
    before = counts()
    ids = cs.ls_decode(paddle, m, batches[0]["src"], 3, 6)
    got = [a - b for a, b in zip(counts(), before)]
    assert got == [int(ids.shape[1]), 0, 0, 0]


def test_lstm_equals_rnn_of_lstm_cells_on_the_card(dev, no_tf32):
    """``nn.LSTM`` (one cuDNN call a layer) against two
    ``nn.RNN(nn.LSTMCell)`` layers (one fused cell a step) over the same
    weights: outputs and final states within 1e-5, every gradient within
    1e-5 of its largest element (cuDNN sums a weight's gradient over every
    step in one product, the cells step by step)."""
    import paddle1_tpu_torch as paddle
    with paddle.device_guard("gpu:0"), paddle.utils.unique_name.guard():
        net = paddle.nn.LSTM(32, 48, 2)
        cells = [paddle.nn.RNN(paddle.nn.LSTMCell(32 if k == 0 else 48, 48))
                 for k in range(2)]
    for k, rnn in enumerate(cells):
        rnn.cell.set_state_dict({n: getattr(net, f"{n}_l{k}") for n in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh")})
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(6, 9, 32, device=dev, generator=g)
    w = torch.randn(6, 9, 48, device=dev, generator=g)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out_a, (h_a, c_a) = net(xa)
    y, finals = xb, []
    for rnn in cells:
        y, st = rnn(y)
        finals.append(st)
    h_b = torch.stack([f[0] for f in finals])
    c_b = torch.stack([f[1] for f in finals])
    ((out_a * w).sum() + h_a.sum() + c_a.sum()).backward()
    ((y * w).sum() + h_b.sum() + c_b.sum()).backward()
    for a, b in ((out_a, y), (h_a, h_b), (c_a, c_b)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    grads = [(xa.grad, xb.grad)]
    for k, rnn in enumerate(cells):
        grads += [(getattr(net, f"{n}_l{k}").grad, getattr(rnn.cell, n).grad)
                  for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    for a, b in grads:
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_lstm_weights_take_cudnn_s_layout_without_a_warning(dev):
    """On the card each layer's weights become views into one buffer in
    cuDNN's layout where they are made (no copy and no warning at each
    call), keep their values and ``Parameter`` objects, and take it again
    after a move."""
    import warnings
    import paddle1_tpu_torch as paddle
    with paddle.device_guard("gpu:0"), paddle.utils.unique_name.guard():
        net = paddle.nn.GRU(8, 16, 2, "bidirect")
    params = list(net.parameters())
    before = [p.detach().clone() for p in params]
    x = torch.randn(3, 5, 8, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = net(x)[0]
        assert torch.equal(net(x)[0], out)
    assert [id(p) for p in net.parameters()] == [id(p) for p in params]
    for p, b in zip(params, before):
        assert torch.equal(p, b)
    layer0 = net._layer_params(0)
    base = layer0[0].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base for p in layer0)
    net.to("cpu")
    net.to(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        torch.testing.assert_close(net(x)[0], out)


class _Blocks:
    """Sample ``i``: a ``[256, 256]`` f32 block of small integers (its
    float64 sum exact) and ``[i]``."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        cols = np.arange(256, dtype=np.float32) % 7
        return (np.full((256, 256), i % 97, np.float32) + cols[None, :],
                np.array([i], np.int64))


@pytest.mark.parametrize("workers", [0, 2], ids=["thread", "processes"])
def test_loader_batches_on_the_copy_stream_equal_their_host_arrays(
        dev, workers):
    import paddle1_tpu_torch as paddle
    ds, bs, n = _Blocks(400), 8, 50
    a = torch.randn(2048, 2048, device=dev)
    heads, sums = [], []
    with paddle.device_guard("gpu:0"):
        it = iter(paddle.io.DataLoader(ds, batch_size=bs,
                                       num_workers=workers,
                                       prefetch_factor=4))
        try:
            for x, y in it:
                assert x.device == dev and y.device == dev
                x = x.as_subclass(torch.Tensor)
                heads.append(x.clone())          # read at once
                for _ in range(4):               # the compute stream busy
                    a = torch.tanh(a @ a)
                sums.append(x.sum(dtype=torch.float64) + 0 * a[0, 0])
                del x, y                         # read again after it
        finally:
            it.shutdown()
    torch.cuda.synchronize()
    assert len(heads) == n
    for k in range(n):
        want = np.stack([ds[i][0] for i in range(k * bs, (k + 1) * bs)])
        assert np.array_equal(heads[k].cpu().numpy(), want), k
        assert float(sums[k]) == float(want.astype(np.float64).sum()), k
