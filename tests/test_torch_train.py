"""The BERT pretraining slice of the PyTorch port against the JAX package,
on the CPU.

Inputs come from numpy with a seed and go through both packages; weights
cross through ``paddle1_tpu_torch.convert.state_from_jax``. The JAX side
runs its Pallas kernels (flash forward/backward, fused Adam, LayerNorm)
in interpret mode under ``flags_guard(... "always")``, as its own tests
do; the port's wrappers run their plain versions on CPU tensors (the
CUDA kernels are held to those on the card by ``chip_smoke.py``).
Everything is float32; each tolerance is stated where it is used.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.core.tensor import Tensor, to_tensor
from paddle1_tpu.nn import functional as jF
from paddle1_tpu.ops.pallas import flash_attention as jfa
from paddle1_tpu.ops.pallas import fused_adam as jadam
from paddle1_tpu.ops.pallas import layer_norm as jln
from paddle1_tpu.ops.pallas.flash_attention_bwd import \
    flash_attention_bwd as j_flash_bwd
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.distributed import ParallelEngine
from paddle1_tpu_torch.nn import TransformerEncoderLayer
from paddle1_tpu_torch.nn import functional as tF
from paddle1_tpu_torch.ops import flash_attention as tfa
from paddle1_tpu_torch.ops import flash_attention_bwd as tfb
from paddle1_tpu_torch.ops import fused_adam as tadam
from paddle1_tpu_torch.optimizer import AdamW
from paddle1_tpu_torch.text.models import (BertForPretraining, BertModel,
                                           BertPretrainingCriterion)

# flash forward: both sides sum 32-64 products per score in f32 in other
# orders, and exp/log of those; 2e-5 covers that at these sizes
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
# backward: two more chained products (dp, ds) over up to 256 keys
BWD_TOL = dict(atol=1e-4, rtol=1e-4)
# Adam: the JAX package's own tolerance for its kernel against plain jnp
# (tests/test_fused_kernels.py:313)
ADAM_TOL = dict(rtol=1e-6, atol=1e-7)
LN_TOL = dict(atol=1e-5, rtol=1e-5)
MOD_TOL = dict(atol=1e-4, rtol=1e-4)
# the bf16 tensor-core kernels' arithmetic on bf16-valued inputs against
# the JAX package's f32 flash: the products are exact in both, the sums run
# in other orders, and P and dS enter their products as bf16 hi + lo (about
# 2^-17 relative per term); the card holds the kernels to their plain
# versions to the same 1e-4 (chip_smoke.py's FLASH_BF16_ABS, beyond one
# bf16 rounding step of the stored value, which the emulation leaves out)
FLASH_BF16_ABS = 1e-4
ALWAYS = dict(flash_attention="always", flash_backward="always",
              fused_adam="always")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _attn_case(seed, nq, nk, h, d, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, nq, h, d)).astype(np.float32)
    k = rng.standard_normal((2, nk, h, d)).astype(np.float32)
    v = rng.standard_normal((2, nk, h, d)).astype(np.float32)
    pm = None
    if masked:
        pm = np.ones((2, nk), np.float32)
        pm[0, nk // 2 + 5:] = 0.0   # a padded tail
        pm[1] = 0.0                 # a fully padded batch row
    dout = rng.standard_normal((2, nq, h, d)).astype(np.float32)
    return q, k, v, pm, dout


ATTN_CASES = [  # nq, nk, heads, dim, causal
    (128, 128, 2, 32, False),
    (128, 128, 2, 32, True),
    (256, 256, 4, 64, False),
    (128, 256, 2, 64, True),    # bottom-right causal, nq < nk
]


# ---------------------------------------------------------------------------
# flash attention


@pytest.mark.parametrize("nq,nk,h,d,causal", ATTN_CASES)
def test_flash_ref_matches_pallas_forward(nq, nk, h, d, causal):
    q, k, v, pm, _ = _attn_case(nq + d, nq, nk, h, d)
    scale = 1.0 / math.sqrt(d)
    want_o, want_l = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale, causal,
                                    padding_mask=jnp.asarray(pm))
    got_o, got_l = tfa.flash_attention_ref(_t(q), _t(k), _t(v), scale,
                                           causal, _t(pm) > 0.5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **FWD_TOL)
    # the fully padded row: O = 0 and the -1e30 sentinel in both
    np.testing.assert_array_equal(got_o.numpy()[1], 0.0)
    assert float(got_l[1].max()) == pytest.approx(-1e30)
    live = np.asarray(want_l) > -1e29
    np.testing.assert_array_equal(got_l.numpy() > -1e29, live)
    np.testing.assert_allclose(got_l.numpy()[live], np.asarray(want_l)[live],
                               **FWD_TOL)


@pytest.mark.parametrize("nq,nk,h,d,causal", ATTN_CASES)
def test_flash_bwd_ref_matches_pallas_backward(nq, nk, h, d, causal):
    q, k, v, pm, dout = _attn_case(7 * nq + d, nq, nk, h, d)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jpm = (jnp.asarray(a) for a in (q, k, v, pm))
    out, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, padding_mask=jpm)
    want = j_flash_bwd(jq, jk, jv, out, lse, jnp.asarray(dout), scale,
                       causal, padding_mask=jpm)
    got = tfa.flash_bwd_ref(_t(q), _t(k), _t(v), _t(np.asarray(out)),
                            _t(np.asarray(lse)), _t(dout), scale, causal,
                            _t(pm) > 0.5)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)
    # the fully padded batch row gets an exact zero gradient
    for g in got:
        np.testing.assert_array_equal(g.numpy()[1], 0.0)


TC_CASES = ATTN_CASES + [(128, 256, 2, 128, False)]   # + ERNIE's D = 128


def _bf16_valued(*arrays):
    return [np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
            for a in arrays]


@pytest.mark.parametrize("nq,nk,h,d,causal", TC_CASES)
def test_tensor_core_forward_emulation_matches_pallas(nq, nk, h, d, causal):
    q, k, v, pm, _ = _attn_case(3 * nq + d, nq, nk, h, d)
    q, k, v = _bf16_valued(q, k, v)
    scale = 1.0 / math.sqrt(d)
    want_o, want_l = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale, causal,
                                    padding_mask=jnp.asarray(pm))
    got_o, got_l = tfa.flash_fwd_tc_emulation(_t(q), _t(k), _t(v), scale,
                                              causal, _t(pm) > 0.5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0,
                               atol=FLASH_BF16_ABS)
    np.testing.assert_array_equal(got_o.numpy()[1], 0.0)
    live = np.asarray(want_l) > -1e29
    np.testing.assert_array_equal(got_l.numpy() > -1e29, live)
    assert float(got_l[1].max()) == pytest.approx(-1e30)
    np.testing.assert_allclose(got_l.numpy()[live], np.asarray(want_l)[live],
                               **FWD_TOL)


@pytest.mark.parametrize("nq,nk,h,d,causal", TC_CASES)
def test_tensor_core_dkv_emulation_matches_pallas(nq, nk, h, d, causal):
    q, k, v, pm, dout = _attn_case(5 * nq + d, nq, nk, h, d)
    q, k, v, dout = _bf16_valued(q, k, v, dout)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jpm = (jnp.asarray(a) for a in (q, k, v, pm))
    out, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, padding_mask=jpm)
    _, want_k, want_v = j_flash_bwd(jq, jk, jv, out, lse, jnp.asarray(dout),
                                    scale, causal, padding_mask=jpm)
    delta = (dout * np.asarray(out)).sum(-1).transpose(0, 2, 1)
    got_k, got_v = tfb.flash_bwd_dkv_tc_emulation(
        _t(q), _t(k), _t(v), _t(dout), _t(np.asarray(lse)), _t(delta),
        scale, causal, _t(pm) > 0.5)
    for g, w, name in ((got_k, want_k, "dk"), (got_v, want_v, "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   rtol=0, atol=FLASH_BF16_ABS)
        np.testing.assert_array_equal(g.numpy()[1], 0.0)


@pytest.mark.parametrize("nq,nk,h,d,causal", TC_CASES)
def test_tensor_core_dq_emulation_matches_pallas(nq, nk, h, d, causal):
    q, k, v, pm, dout = _attn_case(9 * nq + d, nq, nk, h, d)
    q, k, v, dout = _bf16_valued(q, k, v, dout)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jpm = (jnp.asarray(a) for a in (q, k, v, pm))
    out, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, padding_mask=jpm)
    want_q, _, _ = j_flash_bwd(jq, jk, jv, out, lse, jnp.asarray(dout),
                               scale, causal, padding_mask=jpm)
    delta = (dout * np.asarray(out)).sum(-1).transpose(0, 2, 1)
    got_q = tfb.flash_bwd_dq_tc_emulation(
        _t(q), _t(k), _t(v), _t(dout), _t(np.asarray(lse)), _t(delta),
        scale, causal, _t(pm) > 0.5)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=0,
                               atol=FLASH_BF16_ABS)
    # the fully padded batch row gets an exact zero gradient
    np.testing.assert_array_equal(got_q.numpy()[1], 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_autograd_of_attention_ref(causal):
    # the autograd function (plain forward + plain backward on the CPU)
    # against torch.autograd through the dense composition; only the
    # partly padded batch row, since attention_ref averages a row with no
    # visible key uniformly where flash gives 0
    q, k, v, pm, dout = _attn_case(3, 128, 128, 2, 32)
    pm[1] = 1.0
    keep = _t(pm) > 0.5
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, padding_mask=keep)
    (out * _t(dout)).sum().backward()
    ref_leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    ref = tF.attention_ref(*ref_leaves, mask=keep[:, None, None, :],
                           is_causal=causal)
    (ref * _t(dout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **FWD_TOL)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   **BWD_TOL)


def test_flash_backward_flag_never_takes_the_plain_backward(monkeypatch):
    from paddle1_tpu_torch.ops import flash_attention_bwd as tfb
    calls = []
    monkeypatch.setattr(tfb, "flash_attention_bwd",
                        lambda *a: calls.append(1) or tfa.flash_bwd_ref(*a))
    q, k, v, pm, dout = _attn_case(4, 128, 128, 2, 16, masked=False)
    for mode, want in (("always", 1), ("never", 0)):
        calls.clear()
        leaves = [_t(a).requires_grad_() for a in (q, k, v)]
        with tflags.flags_guard(flash_backward=mode):
            tfa.flash_attention(*leaves).sum().backward()
        assert len(calls) == want, mode


# ---------------------------------------------------------------------------
# sdpa routing


def _spy_flash(monkeypatch):
    calls = []
    real = tfa.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("padding_mask") is not None)
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("case", ["padding_bool", "padding_additive",
                                  "soft_bias", "dropout", "no_mask",
                                  "prefill_causal_mask", "eval_dropout"])
def test_sdpa_routes_like_the_jax_package(monkeypatch, case):
    q, k, v, pm, _ = _attn_case(11, 128, 128, 2, 32)
    pm[1, :3] = 1.0  # no fully padded row, so dense and flash agree
    keep = (pm > 0.5)[:, None, None, :]
    mask, kw, want = None, {}, None
    if case == "padding_bool":
        mask, want = keep, [True]
    elif case == "padding_additive":
        mask, want = np.where(keep, 0.0, -1e9).astype(np.float32), [True]
    elif case == "soft_bias":
        mask = np.where(keep, 0.5, -1e9).astype(np.float32)
        want = []
    elif case == "dropout":
        mask, kw, want = keep, dict(dropout_p=0.1), []
    elif case == "eval_dropout":
        mask, kw, want = keep, dict(dropout_p=0.1, training=False), [True]
    elif case == "no_mask":
        want = [False]
    elif case == "prefill_causal_mask":
        mask, want = np.tril(np.ones((128, 128), bool))[None, None], []
    calls = _spy_flash(monkeypatch)
    tmask = None if mask is None else _t(mask)
    with tflags.flags_guard(flash_attention="always"):
        got = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                              attn_mask=tmask, **kw)
    assert calls == want
    if case == "dropout":
        return  # different random bits in the two packages
    jkw = dict(kw)
    with jax_flags_guard(flash_attention="always", flash_backward="always"):
        ref = jF.scaled_dot_product_attention(
            to_tensor(q), to_tensor(k), to_tensor(v),
            attn_mask=None if mask is None else to_tensor(mask), **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()),
                               **FWD_TOL)


def test_sdpa_dropout_keeps_the_expected_share():
    q, k, v, _, _ = _attn_case(12, 128, 128, 2, 16, masked=False)
    g = torch.Generator().manual_seed(0)
    v1 = np.ones_like(v)
    out = tF.scaled_dot_product_attention(_t(q), _t(k), _t(v1),
                                          dropout_p=0.25, generator=g)
    # with V = 1 each output is the kept probability mass / 0.75: mean 1
    assert abs(float(out.mean()) - 1.0) < 0.02


# ---------------------------------------------------------------------------
# fused Adam


@pytest.mark.parametrize("n,step,decay", [(8192 + 123, 3, 0.01),
                                          (3 * 8192, 1, 0.0)])
def test_fused_adam_ref_matches_pallas(n, step, decay):
    rng = np.random.default_rng(n)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    m1 = (rng.standard_normal(n) * 0.01).astype(np.float32)
    m2 = np.abs(rng.standard_normal(n) * 0.01).astype(np.float32)
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    want = jadam.fused_adam_update(jnp.asarray(p), jnp.asarray(g),
                                   jnp.asarray(m1), jnp.asarray(m2), lr,
                                   jnp.asarray(step, jnp.int32), b1, b2,
                                   eps, decay)
    st = torch.tensor(float(step))
    bc1, bc2 = 1.0 - torch.pow(b1, st), 1.0 - torch.pow(b2, st)
    got = tadam.fused_adam_ref(_t(p), _t(g), _t(m1), _t(m2),
                               torch.tensor(lr), bc1, bc2, decay, b1, b2, eps)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ADAM_TOL)


def test_fused_adam_list_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    shapes = [(7,), (33, 5), (2, 3, 4)]
    ps = [_t(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    gs = [_t(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    m1 = [torch.zeros(s) for s in shapes]
    m2 = [torch.zeros(s) for s in shapes]
    sc = torch.tensor([1e-2, 0.1, 0.001])
    want = [tadam.fused_adam_ref(p, g, a, b, sc[0], sc[1], sc[2], d,
                                 0.9, 0.999, 1e-8)
            for p, g, a, b, d in zip(ps, gs, m1, m2, (0.0, 0.01, 0.1))]
    before = tadam.fused_adam_.launches
    tadam.fused_adam_(ps, gs, m1, m2, sc, [0.0, 0.01, 0.1], 0.9, 0.999, 1e-8)
    assert tadam.fused_adam_.launches == before    # no kernel on the CPU
    for p, a, b, w in zip(ps, m1, m2, want):
        for got, exp in zip((p, a, b), w):
            torch.testing.assert_close(got, exp, rtol=0, atol=0)
    with pytest.raises(InvalidArgumentError, match="lengths"):
        tadam.fused_adam_(ps, gs[:2], m1, m2, sc, [0.0] * 3, 0.9, 0.999, 1e-8)


def _opt_run(mode, steps=3, cls=AdamW, **kw):
    rng = np.random.default_rng(5)
    w = torch.nn.Parameter(_t(rng.standard_normal((64, 32)).astype(
        np.float32)))
    b = torch.nn.Parameter(torch.zeros(32))
    opt = cls(learning_rate=1e-2, parameters=[w, b, w], **kw)  # w tied
    opt.rename({id(w): "w", id(b): "b"})
    with tflags.flags_guard(fused_adam=mode):
        for i in range(steps):
            w.grad = _t(rng.standard_normal((64, 32)).astype(np.float32))
            b.grad = _t(rng.standard_normal(32).astype(np.float32))
            opt.step()
    return opt, w, b


@pytest.mark.parametrize("name,kw", [("AdamW", {}),
                                     ("Adam", dict(weight_decay=0.01))])
def test_adam_family_matches_jax_functional_update_over_steps(name, kw):
    # AdamW: decoupled decay 0.01 (the default); Adam: an L2 term 0.01
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((64, 32)).astype(np.float32)
    grads = [(rng.standard_normal((64, 32)).astype(np.float32),
              rng.standard_normal(32).astype(np.float32)) for _ in range(3)]
    jopt = getattr(paddle.optimizer, name)(learning_rate=1e-2, **kw)
    params = {"w": jnp.asarray(w0), "b": jnp.zeros(32, jnp.float32)}
    state = jopt.functional_init(params)
    for gw, gb in grads:
        params, state = jopt.functional_update(
            params, {"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, state,
            jnp.float32(1e-2))
    from paddle1_tpu_torch import optimizer as topt
    for mode in ("always", "never"):
        opt, w, b = _opt_run(mode, cls=getattr(topt, name), **kw)
        assert len(opt._params) == 2
        np.testing.assert_allclose(w.detach().numpy(),
                                   np.asarray(params["w"]), **ADAM_TOL)
        np.testing.assert_allclose(b.detach().numpy(),
                                   np.asarray(params["b"]), **ADAM_TOL)


def test_adamw_apply_decay_param_fun_and_state_round_trip():
    opt, w, b = _opt_run("always",
                         apply_decay_param_fun=lambda n: n != "b")
    assert opt._decay("w") == 0.01 and opt._decay("b") == 0.0
    sd = opt.state_dict()
    assert sd["step"] == 3 and set(sd) == {"step", "w__moment1",
                                           "w__moment2", "b__moment1",
                                           "b__moment2"}
    fresh = AdamW(learning_rate=1e-2, parameters=[w, b])
    fresh.rename({id(w): "w", id(b): "b"})
    fresh.set_state_dict(sd)
    for k, v in fresh.state_dict().items():
        if k == "step":
            assert v == 3
        else:
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_optimizer_grad_clip_and_clear_grad():
    # grad_clip gets the (param, grad) pairs and its output is what the
    # update sees: a clip that zeroes every gradient leaves AdamW with only
    # its decoupled decay
    w = torch.nn.Parameter(torch.ones(4))
    seen = []

    def clip(pairs):
        seen.append(len(pairs))
        return [(p, torch.zeros_like(g)) for p, g in pairs]
    opt = AdamW(learning_rate=0.1, parameters=[w], grad_clip=clip)
    w.grad = torch.full((4,), 5.0)
    opt.step()
    assert seen == [1]
    torch.testing.assert_close(w.detach(), torch.full((4,), 1 - 0.1 * 0.01))
    opt.clear_grad(set_to_zero=True)
    assert float(w.grad.abs().sum()) == 0.0
    opt.clear_grad()
    assert w.grad is None


# ---------------------------------------------------------------------------
# LayerNorm under autograd, losses, activations


@pytest.mark.parametrize("rows,h", [(16, 128), (24, 64)])
def test_layer_norm_autograd_matches_jax_grad(rows, h):
    rng = np.random.default_rng(rows + h)
    x = (rng.standard_normal((rows, h)) * 2 + 0.3).astype(np.float32)
    w = rng.standard_normal(h).astype(np.float32)
    b = rng.standard_normal(h).astype(np.float32)
    dy = rng.standard_normal((rows, h)).astype(np.float32)
    want = jax.grad(lambda x, w, b: jnp.sum(
        jln.fused_layer_norm(x, w, b) * dy), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [_t(a).requires_grad_() for a in (x, w, b)]
    with tflags.flags_guard(fused_layer_norm="always"):
        y = tF.layer_norm(leaves[0], h, leaves[1], leaves[2])
    (y * _t(dy)).sum().backward()
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   **LN_TOL)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 17)).astype(np.float32)
    y = rng.integers(0, 17, (3, 5)).astype(np.int32)
    y[0, :2] = -1
    for red in ("none", "mean", "sum"):
        want = jF.cross_entropy(to_tensor(x), to_tensor(y), ignore_index=-1,
                                reduction=red)
        got = tF.cross_entropy(_t(x), _t(y), ignore_index=-1, reduction=red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   atol=1e-5, rtol=1e-5, err_msg=red)
    with pytest.raises(InvalidArgumentError):
        tF.cross_entropy(_t(x), _t(y), reduction="max")


def test_gelu_tanh_and_dropout():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(tF.gelu(_t(x)).numpy(),
                               np.asarray(jF.gelu(to_tensor(x)).numpy()),
                               atol=1e-6)
    np.testing.assert_allclose(tF.tanh(_t(x)).numpy(), np.tanh(x),
                               atol=1e-6)
    t = torch.ones(20000)
    assert tF.dropout(t, 0.0) is t and \
        tF.dropout(t, 0.5, training=False) is t
    d = tF.dropout(t, 0.3, generator=torch.Generator().manual_seed(1))
    kept = float((d > 0).float().mean())
    assert abs(kept - 0.7) < 0.02
    np.testing.assert_allclose(d[d > 0].numpy(), 1 / 0.7, rtol=1e-6)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_jax(normalize_before):
    from paddle1_tpu.nn import TransformerEncoderLayer as JLayer
    paddle.seed(4)
    jl = JLayer(64, 2, 128, dropout=0.0, activation="gelu",
                normalize_before=normalize_before)
    tl = TransformerEncoderLayer(64, 2, 128, dropout=0.0, activation="gelu",
                                 normalize_before=normalize_before,
                                 device="cpu")
    tl.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jl.functional_state().items()}, tl))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    mask = np.ones((2, 1, 1, 16), bool)
    mask[1, ..., 12:] = False
    want = jl(to_tensor(x), to_tensor(mask))
    got = tl(_t(x), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want.numpy()), **MOD_TOL)


def test_training_flags_default_to_the_card():
    from paddle1_tpu.core import flags as jflags
    for name in ("flash_attention", "flash_backward", "fused_adam"):
        assert tflags._registry[name].default == "auto"
        assert name in jflags._registry     # the JAX name is kept
    # the port's defaults differ from the TPU-measured ones on purpose
    assert jflags._registry["fused_adam"].default == "never"
    with pytest.raises(InvalidArgumentError):
        tflags.flag("flash_auto_score_mb")  # a TPU sweep's threshold


# ---------------------------------------------------------------------------
# tiny BERT through both ParallelEngines

CFG = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=128,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
STEPS, LR = 5, 1e-3


def _batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, (2, 128)).astype(np.int32)
    ids[1, 90:] = 0                      # one padded tail
    mlm = rng.integers(0, 512, (2, 128)).astype(np.int32)
    mlm[ids == 0] = -1                   # ignored positions
    nsp = rng.integers(0, 2, (2,)).astype(np.int32)
    return {"ids": ids, "mlm": mlm, "nsp": nsp}


@pytest.fixture(scope="module")
def bert_pair():
    from paddle1_tpu.text.models import BertForPretraining as JBert
    from paddle1_tpu.text.models import BertModel as JBertModel
    from paddle1_tpu.text.models import BertPretrainingCriterion as JCrit
    paddle.seed(0)
    jm = JBert(JBertModel(**CFG))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm = BertForPretraining(BertModel(device="cpu", **CFG))
    tm.load_state_dict(state_from_jax(state, tm))
    return jm, JCrit(512), tm, BertPretrainingCriterion(512), state


def test_bert_state_names_and_tied_decoder(bert_pair):
    jm, _, tm, _, state = bert_pair
    # 15 names outside the encoder + 16 per layer, the tied pair included
    assert set(tm.state_dict()) == set(state) and len(state) == 15 + 16 * 2
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    names = [n for n, _ in tm.named_parameters()]
    assert "cls.decoder_weight" not in names and len(names) == len(state) - 1
    bad = dict(state)
    bad["cls.decoder_weight"] = bad["cls.decoder_weight"] + 1.0
    with pytest.raises(InvalidArgumentError, match="tied"):
        state_from_jax(bad, tm)


def test_bert_forward_scores_and_loss_match_jax(bert_pair):
    jm, jc, tm, tc, _ = bert_pair
    b = _batch()
    with jax_flags_guard(**ALWAYS), paddle.no_grad():
        js, jr = jm(Tensor(jnp.asarray(b["ids"])))
        jl = jc(js, jr, Tensor(jnp.asarray(b["mlm"])),
                Tensor(jnp.asarray(b["nsp"])))
    with tflags.flags_guard(fused_layer_norm="always", **ALWAYS), \
            torch.no_grad():
        ts, tr = tm(_t(b["ids"]))
        tl = tc(ts, tr, _t(b["mlm"]), _t(b["nsp"]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()), **MOD_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr.numpy()), **MOD_TOL)
    assert float(tl) == pytest.approx(float(np.asarray(jl.numpy())),
                                      abs=1e-5)


def test_bert_masked_positions_head_matches_jax(bert_pair):
    jm, _, tm, _, _ = bert_pair
    b = _batch()
    pos = np.array([3, 17, 130, 200, 255], np.int32)   # into [B*S] rows
    with jax_flags_guard(**ALWAYS), paddle.no_grad():
        js, _ = jm(Tensor(jnp.asarray(b["ids"])),
                   masked_positions=Tensor(jnp.asarray(pos)))
    with torch.no_grad():
        ts, _ = tm(_t(b["ids"]), masked_positions=_t(pos))
    assert tuple(ts.shape) == (5, 512)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()), **MOD_TOL)


@pytest.fixture(scope="module")
def trained(bert_pair):
    """Five AdamW steps through both engines from identical weights."""
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh
    # the JAX engine copies the Layer's arrays at init and never writes
    # them back (no sync_model), so bert_pair's models stay as loaded
    jm, jc, _, tc, state = bert_pair
    tm = BertForPretraining(BertModel(device="cpu", **CFG))
    tm.load_state_dict(state_from_jax(state, tm))
    b = _batch()

    def jloss(m, batch):
        s, r = m(Tensor(batch["ids"]))
        return jc(s, r, Tensor(batch["mlm"]), Tensor(batch["nsp"]))

    def tloss(m, batch):
        s, r = m(batch["ids"])
        return tc(s, r, batch["mlm"], batch["nsp"])

    with jax_flags_guard(**ALWAYS):
        jeng = JEngine(jm, paddle.optimizer.AdamW(
            learning_rate=LR, parameters=jm.parameters()), jloss,
            mesh=build_mesh(dp=1, devices=[jax.devices()[0]]))
        jlosses = [float(jeng.step(b)) for _ in range(STEPS)]
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    teng = ParallelEngine(tm, opt, tloss)
    with tflags.flags_guard(fused_layer_norm="always", **ALWAYS):
        tlosses = [float(teng.step(b)) for _ in range(STEPS)]
    jparams = {k: np.asarray(v) for k, v in jeng.params.items()}
    return jlosses, tlosses, jparams, tm, teng


def test_bert_five_adamw_steps_match_jax_engine(trained):
    jlosses, tlosses, jparams, tm, teng = trained
    assert teng.dispatch_count == STEPS
    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=0)
    checked = 0
    for name, p in tm.state_dict().items():
        if name not in jparams:
            continue      # the tied alias: the JAX engine keeps one name
        got, want = p.numpy(), jparams[name]
        if name.endswith("k_proj.bias"):
            # softmax is invariant to a per-query shift of the logits, so
            # the key bias's gradient is exactly 0 in exact arithmetic and
            # rounding noise in both packages; Adam normalizes that noise
            # against eps, so this bias moves by up to lr per step in each
            # package independently: held to STEPS * lr, not 1e-4
            np.testing.assert_allclose(got, want, atol=STEPS * LR, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0,
                                       err_msg=name)
        checked += 1
    assert checked == len(jparams) == 46


def test_bert_tied_weight_is_one_tensor_after_steps(trained):
    _, _, jparams, tm, teng = trained
    emb = tm.bert.embeddings.word_embeddings.weight
    assert tm.cls.decoder_weight is emb
    sd = tm.state_dict()
    assert torch.equal(sd["cls.decoder_weight"],
                       sd["bert.embeddings.word_embeddings.weight"])
    # one optimizer slot pair for the tied weight, under its first name
    assert "bert.embeddings.word_embeddings.weight" in teng.names
    assert "cls.decoder_weight" not in teng.names
    assert len(teng.optimizer._params) == 46
    np.testing.assert_allclose(emb.detach().numpy(),
                               jparams["bert.embeddings.word_embeddings."
                                       "weight"], atol=1e-4, rtol=0)


def test_bf16_engine_keeps_f32_masters(bert_pair):
    # amp_dtype="bfloat16" on the CPU: the forward/backward run in bf16,
    # the masters stay f32 and the loss is f32; the first loss is within
    # bf16 rounding of the f32 one
    _, _, _, tc, state = bert_pair
    tm = BertForPretraining(BertModel(device="cpu", **CFG))
    tm.load_state_dict(state_from_jax(state, tm))

    def tloss(m, batch):
        s, r = m(batch["ids"])
        assert s.dtype == torch.bfloat16
        return tc(s, r, batch["mlm"], batch["nsp"])
    eng = ParallelEngine(tm, AdamW(learning_rate=LR), tloss,
                         amp_dtype="bfloat16")
    losses = [eng.step(_batch()) for _ in range(2)]
    assert losses[0].tensor.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert float(losses[0]) == pytest.approx(6.4352, abs=0.05)
    assert math.isfinite(float(losses[1]))
    with pytest.raises(InvalidArgumentError, match="amp_dtype"):
        ParallelEngine(tm, AdamW(), tloss, amp_dtype="int8")
