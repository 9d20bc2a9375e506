"""Checks of the PyTorch port that need a CUDA card.

Marked ``cuda``; without a card they skip. On the card, from the repo
root (this file imports nothing of JAX, so the JAX test conftest is
left out)::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

They hold that on CUDA tensors the functionals always go through the
kernels' wrappers: inputs outside a kernel's contract raise instead of
running the plain version, and a bf16 KV pool under f32 queries runs the
kernel and agrees with the plain version. For the training kernels
(flash forward, its dK/dV and dQ passes, fused AdamW) they hold the same,
the bf16 tensor-core forward, dK/dV and dQ passes to their plain versions
at every D bucket, causal and padded, and that a tiny BERT step on the
card launches each of them; the LayerNorm kernel to its plain version
on the warp-per-row and block-per-row paths, with and without 16-byte
vectors, in f32 and bf16. For the
fused batch-norm family (training and given-statistics forward, their
backward passes) they hold each kernel to its plain version across the
activation x residual matrix in f32 and bf16, that inputs outside the
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
(the eager slice) they hold it to its plain version on the warp and block
paths, with and without 16-byte vectors, in f32 and bf16, its contract
and its launch counter; and that the eager LeNet runs on the card by
default, on Paddle tensors whose ``.numpy()`` reads the card, with one
fused Adam launch per step and one softmax launch per prediction.
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
    x = torch.randn(4, 64, device=dev, dtype=torch.float16)
    w = torch.ones(64, device=dev, dtype=torch.float16)
    with pytest.raises(InvalidArgumentError, match="contract"):
        F.layer_norm(x, 64, w, torch.zeros_like(w))


@pytest.mark.parametrize("kw", [
    dict(q_dtype=torch.float16, kv_dtype=torch.float16),
    dict(kv_dtype=torch.float16),
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


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
        else:
            assert _bf16_excess(got, want) <= 1e-5, rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    else:
        assert _bf16_excess(got, want) <= 1e-5


def _qkv(dev, shape=(2, 128, 2, 64), dtype=torch.float32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, device=dev, generator=g).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("shape,dtype", [
    ((2, 128, 2, 64), torch.float16),
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


def _bf16_excess(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() - 2.0 ** -7 * want.abs()).max())


@pytest.mark.parametrize("nq,nk,d,causal", [
    (256, 256, 64, False), (256, 256, 64, True), (128, 256, 64, True),
    (256, 256, 128, False), (128, 256, 128, True), (256, 256, 256, False),
    (128, 256, 256, True), (128, 128, 40, False), (128, 256, 96, True),
])
def test_bf16_tensor_core_flash_matches_its_plain_version(dev, nq, nk, d,
                                                          causal):
    """The tensor-core forward, dK/dV and dQ passes at each D bucket (64,
    128, 256; 40 and 96 zero-padded in shared memory), causal and padded,
    one batch row fully padded; all three repeat bit for bit."""
    g = torch.Generator(device=dev).manual_seed(nq + nk + d)
    q, do = (torch.randn(3, nq, 2, d, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(3, nk, 2, d, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(2))
    keep = torch.ones(3, nk, dtype=torch.bool, device=dev)
    keep[0, nk // 2 + 3:] = False
    keep[1] = False
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale, causal, keep)
    ro, rl = fa.flash_attention_ref(q, k, v, scale, causal, keep)
    assert _bf16_excess(out, ro) <= FLASH_BF16_ABS
    live = rl > -1e29
    assert torch.equal(lse > -1e29, live)
    assert float((lse - rl)[live].abs().max()) <= FLASH_TOL
    assert float(out[1].abs().max()) == 0.0
    delta = (do.float() * ro.float()).sum(-1).transpose(1, 2)
    dk, dv = fb.flash_bwd_dkv(q, k, v, do, rl, delta, scale, causal, keep)
    dq = fb.flash_bwd_dq(q, k, v, do, rl, delta, scale, causal, keep)
    rq, rk, rv = fa.flash_bwd_ref(q, k, v, ro, rl, do, scale, causal, keep)
    assert _bf16_excess(dk, rk) <= FLASH_BF16_ABS
    assert _bf16_excess(dv, rv) <= FLASH_BF16_ABS
    assert _bf16_excess(dq, rq) <= FLASH_BF16_ABS
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
    p = torch.zeros(10, device=dev, dtype=torch.float16)
    m = torch.zeros(10, device=dev)
    sc = torch.zeros(3, device=dev)
    with pytest.raises(InvalidArgumentError, match="contract"):
        fad.fused_adam_([p], [p], [m], [m], sc, [0.0], 0.9, 0.999, 1e-8)
    p32 = torch.zeros(10, device=dev)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        fad.fused_adam_([p32], [p32.to(torch.bfloat16)], [m], [m], sc,
                        [0.0], 0.9, 0.999, 1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
        x = x.half()
    elif case == "strided":
        x = torch.randn(16, 64, device=dev).t()      # [64, 16], not packed
    else:
        g = g.to(torch.bfloat16)
    with pytest.raises(InvalidArgumentError, match="contract"):
        fbn.fused_bn_train(x, g, b, 1e-5)


@pytest.mark.parametrize("case", ["f16", "channels", "affine_less",
                                  "channels_first"])
def test_batch_norm_outside_the_kernel_contract_raises_on_the_card(dev,
                                                                   case):
    from paddle1_tpu_torch.core.flags import flags_guard
    c = 12 if case == "channels" else 16
    x = torch.randn(4, c, 5, 5, device=dev,
                    dtype=torch.float16 if case == "f16" else torch.float32)
    w = None if case == "affine_less" else torch.ones(c, device=dev)
    b = None if case == "affine_less" else torch.zeros(c, device=dev)
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
        x = x.half()
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
