"""Faults of the PyTorch port against the JAX package (ROADMAP Queue 3,
F1-F4 and F6), each held by a test that runs both packages on the same
call.

F1: a ported layer or function takes the reference's arguments in the
reference's positions (the port's own ``device`` and ``generator`` are
keyword-only after them), ``ParamAttr``s included. F2: ``F.dropout``
takes ``axis`` and ``mode``. F3: the Paddle ``Tensor`` facade's ``max``,
``min``, ``sort``, ``shape`` and ``size`` mean what the reference's mean.
F4: ``serving.engine.resolve_buckets`` has the reference's defaults and
flags. F6: a layer's parameters carry the reference's names, which the
optimizer's decay filter and state keys read. F7-F9: the facade's Tensor
methods that share a name with a ``torch.Tensor`` method mean Paddle's
call in user code (``x.split(3, 1)``, ``median``, ``unique``, ``where``,
and the Paddle calls torch's methods refused). F10: ``Tensor(data, dtype,
place, stop_gradient, name)`` is the reference's constructor. F11: a
layer's parameters have the reference ``Parameter``'s methods, and torch's
own code keeps torch's meaning on them. F12: layers made without a device
follow the current place (``set_device``/``device_guard``), and
``init_parallel_env`` makes the rank's device the current place.

Inputs and weights come from numpy with a seed; weights cross through
``paddle1_tpu_torch.convert.state_from_jax``. Random masks differ by
design (jax threefry against torch Philox), so dropout is compared by
structure. Everything is float32; each tolerance is stated where used.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.core.tensor import to_tensor
from paddle1_tpu.nn import functional as jF
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.core.errors import (InvalidArgumentError,
                                           UnimplementedError)
from paddle1_tpu_torch.nn import functional as tF

# one layer's products and sums in f32 in another order
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(t):
    return np.asarray(t.numpy())


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.functional_state().items()}


def _carried(jlayer, tlayer):
    tlayer.load_state_dict(state_from_jax(_state(jlayer), tlayer))
    return tlayer


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# F1: the reference's arguments in the reference's positions


def _positional(fn):
    """The names of ``fn``'s parameters that a caller may pass by position
    (``self`` left out)."""
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind in kinds and n != "self"]


F1_APIS = [
    ("Linear", lambda m: m.nn.Linear.__init__),
    ("Embedding", lambda m: m.nn.Embedding.__init__),
    ("LayerNorm", lambda m: m.nn.LayerNorm.__init__),
    ("MultiHeadAttention", lambda m: m.nn.MultiHeadAttention.__init__),
    ("TransformerEncoderLayer",
     lambda m: m.nn.TransformerEncoderLayer.__init__),
    ("cross_entropy", lambda m: m.nn.functional.cross_entropy),
    ("AdamW", lambda m: m.optimizer.AdamW.__init__),
    ("attention_ref", lambda m: m.nn.functional.attention_ref),
    ("dropout", lambda m: m.nn.functional.dropout),
    ("Dropout", lambda m: m.nn.Dropout.__init__),
]


@pytest.mark.parametrize("name,get", F1_APIS, ids=[a[0] for a in F1_APIS])
def test_positional_parameters_are_the_references(name, get):
    """Every parameter a caller can pass by position is the reference's,
    in the reference's order; the port's own come after, keyword-only."""
    assert _positional(get(tp)) == _positional(get(jp))
    extra = set(inspect.signature(get(tp)).parameters) - \
        set(inspect.signature(get(jp)).parameters)
    assert extra <= {"device", "generator"}


@pytest.mark.parametrize("args,has_bias", [((None,), True),
                                           ((None, None, "fc"), True),
                                           ((None, False), False)])
def test_linear_positional_bias_attr(args, has_bias):
    # Linear(4, 8, None): weight_attr in both packages, so a bias stays
    paddle_linear = jp.nn.Linear(4, 8, *args)
    tl = tp.nn.Linear(4, 8, *args, device="cpu")
    assert (tl.bias is not None) == has_bias == \
        (paddle_linear.bias is not None)
    _carried(paddle_linear, tl)
    x = _x((3, 4), 1)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(),
                               _np(paddle_linear(to_tensor(x))), **TOL)


def _attr_pair(**kw):
    """The same ``ParamAttr`` in both packages (a Constant initializer
    and an L2Decay where ``init``/``l2`` are given)."""
    init, l2 = kw.pop("init", None), kw.pop("l2", None)
    out = []
    for m in (jp, tp):
        extra = {}
        if init is not None:
            extra["initializer"] = m.nn.initializer.Constant(init)
        if l2 is not None:
            extra["regularizer"] = m.regularizer.L2Decay(l2)
        out.append(m.ParamAttr(**kw, **extra))
    return out


def _param_attrs(p):
    return (p.name, tuple(p.shape), p.trainable, dict(p.optimize_attr),
            getattr(p.regularizer, "coeff", None), p.need_clip)


def test_linear_param_attr_matches_the_reference(fresh_names):
    # both packages name the bias from their layer counters: from zero, so
    # the names do not depend on the layers earlier tests made
    jw, tw = _attr_pair(name="w", init=0.5, learning_rate=0.5,
                        trainable=False, need_clip=False, l2=0.1)
    jb, tb = _attr_pair(init=-0.25, learning_rate=2.0)
    jl = jp.nn.Linear(4, 8, jw, jb)
    tl = tp.nn.Linear(4, 8, tw, tb, device="cpu")
    for a, b in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
        assert _param_attrs(b) == _param_attrs(a)
        np.testing.assert_array_equal(b.detach().numpy(), _np(a))
    assert tl.weight.name == "w" and not tl.weight.requires_grad
    x = _x((3, 4), 30)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(),
                               _np(jl(to_tensor(x))), **TOL)


@pytest.mark.parametrize("padding_idx", [0, -1, None])
def test_embedding_positional_padding_idx(padding_idx):
    # Embedding(10, 4, 0): padding_idx in both packages (the parent took
    # it as the device)
    je = jp.nn.Embedding(10, 4, padding_idx)
    te = tp.nn.Embedding(10, 4, padding_idx, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    if padding_idx is not None:
        row = padding_idx % 10
        assert float(te.weight[row].abs().sum()) == 0.0
        assert float(np.abs(_np(je.weight)[row]).sum()) == 0.0
    _carried(je, te)
    ids = np.array([[0, 3, 9], [9, 0, 5]], np.int64)
    np.testing.assert_allclose(te(_t(ids)).detach().numpy(),
                               _np(je(to_tensor(ids))), **TOL)
    # the padding id's output is 0 whatever its row holds, as there
    with torch.no_grad():
        te.weight.fill_(1.0)
    out = te(_t(ids)).detach().numpy()
    if padding_idx is not None:
        assert (out[ids == padding_idx % 10] == 0).all()
    assert (out[ids != (padding_idx if padding_idx is not None else -1)
                % 10] == 1).all()


def test_embedding_sparse_raises():
    with pytest.raises(UnimplementedError):
        tp.nn.Embedding(10, 4, None, True, device="cpu")


def test_layer_norm_positional_attrs():
    jl = jp.nn.LayerNorm(8, 1e-5, None, None, "ln")
    tl = _carried(jl, tp.nn.LayerNorm(8, 1e-5, None, None, "ln",
                                      device="cpu"))
    x = _x((4, 8), 2)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(),
                               _np(jl(to_tensor(x))), **TOL)
    # weight_attr/bias_attr False drop that half of the affine, as there.
    # The reference's forward then raises (its F.layer_norm converts the
    # missing weight with to_tensor(None)), so the port's output is held
    # to the reference's affine layer at its initial ones and zeros
    want = _np(jp.nn.LayerNorm(8, 1e-5)(to_tensor(x)))
    for args in ((False,), (None, False), (False, False)):
        jl = jp.nn.LayerNorm(8, 1e-5, *args)
        tl = _carried(jl, tp.nn.LayerNorm(8, 1e-5, *args, device="cpu"))
        assert (tl.weight is None, tl.bias is None) == \
            (jl.weight is None, jl.bias is None)
        np.testing.assert_allclose(tl(_t(x)).detach().numpy(), want, **TOL)


def test_multi_head_attention_positional_kdim_vdim():
    jm = jp.nn.MultiHeadAttention(16, 2, 0.0, 12, 10)
    tm = _carried(jm, tp.nn.MultiHeadAttention(16, 2, 0.0, 12, 10,
                                               device="cpu"))
    assert tuple(tm.k_proj.weight.shape) == (12, 16)
    assert tuple(tm.v_proj.weight.shape) == (10, 16)
    q, k, v = _x((2, 3, 16), 3), _x((2, 5, 12), 4), _x((2, 5, 10), 5)
    got = tm(_t(q), _t(k), _t(v)).detach().numpy()
    want = _np(jm(to_tensor(q), to_tensor(k), to_tensor(v)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(need_weights=True),
                                dict(fuse_qkv=True),
                                dict(need_weights=True, fuse_qkv=True)])
def test_multi_head_attention_need_weights_fuse_qkv_match_the_reference(kw):
    # need_weights: None in the weights slot; fuse_qkv: the same three
    # projections, as the reference keeps them
    jm = jp.nn.MultiHeadAttention(16, 2, **kw)
    tm = _carried(jm, tp.nn.MultiHeadAttention(16, 2, device="cpu", **kw))
    assert set(tm.state_dict()) == set(_state(jm))
    q = _x((2, 3, 16), 31)
    got, want = tm(_t(q)), jm(to_tensor(q))
    if kw.get("need_weights"):
        assert isinstance(got, tuple) and isinstance(want, tuple)
        assert len(got) == len(want) == 2 and got[1] is None is want[1]
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_encoder_layer_positional_bias_attr():
    # normalize_before, weight_attr, bias_attr by position: no biases
    args = (16, 2, 32, 0.0, "relu", None, None, True, None, False)
    jl = jp.nn.TransformerEncoderLayer(*args)
    tl = _carried(jl, tp.nn.TransformerEncoderLayer(*args, device="cpu"))
    assert tl.normalize_before and tl.linear1.bias is None and \
        tl.self_attn.q_proj.bias is None
    x = _x((2, 4, 16), 6)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(),
                               _np(jl(to_tensor(x))), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_positional_weight(reduction):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = np.array([0, 4, 2, -100, 1, 4], np.int64)
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    want = _np(jF.cross_entropy(to_tensor(x), to_tensor(y), to_tensor(w),
                                -100, reduction))
    got = tF.cross_entropy(_t(x), _t(y), _t(w), -100, reduction).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_weight_with_soft_labels_matches_the_reference(
        reduction):
    # the reference drops the weight with soft labels (loss.py:45)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    soft = rng.dirichlet(np.ones(4), 3).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    want = _np(jF.cross_entropy(to_tensor(x), to_tensor(soft), to_tensor(w),
                                reduction=reduction, soft_label=True))
    got = tF.cross_entropy(_t(x), _t(soft), _t(w), reduction=reduction,
                           soft_label=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_adamw_positional_lr_ratio_then_decay_fn():
    """The eighth argument is lr_ratio and the ninth
    apply_decay_param_fun in both packages: a function that rejects every
    name leaves AdamW undecayed, the reference's weight_decay=0.0 run."""
    import jax.numpy as jnp
    rng = np.random.default_rng(8)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    grads = [rng.standard_normal((8, 4)).astype(np.float32)
             for _ in range(3)]
    jopt = jp.optimizer.AdamW(1e-2, 0.9, 0.999, 1e-8, None, 0.0)
    params = {"w": jnp.asarray(w0)}
    state = jopt.functional_init(params)
    for g in grads:
        params, state = jopt.functional_update(
            params, {"w": jnp.asarray(g)}, state, jnp.float32(1e-2))
    w = torch.nn.Parameter(_t(w0))
    opt = tp.optimizer.AdamW(1e-2, 0.9, 0.999, 1e-8, [w], 0.01, None, None,
                             lambda n: False)
    with tflags.flags_guard(fused_adam="never"):
        for g in grads:
            w.grad = _t(g)
            opt.step()
    # the JAX package's tolerance for its Adam kernel
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(UnimplementedError):
        tp.optimizer.AdamW(1e-2, parameters=[w], lr_ratio=lambda p: 0.5)
    with pytest.raises(UnimplementedError):
        tp.optimizer.AdamW(1e-2, parameters=[w], lazy_mode=True)


def test_attention_ref_positional_dropout_then_scale():
    from paddle1_tpu.nn.functional.attention import attention_ref as jref
    q, k, v = (_x((2, 3, 2, 8), s) for s in (9, 10, 11))
    want = np.asarray(jref(*(np.asarray(a) for a in (q, k, v)), None, 0.0,
                           0.5))
    got = tF.attention_ref(_t(q), _t(k), _t(v), None, 0.0, 0.5).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(InvalidArgumentError):
        tF.attention_ref(_t(q), _t(k), _t(v), None, 0.1, None, False,
                         object())


# ---------------------------------------------------------------------------
# F6: parameter names


@pytest.fixture
def fresh_names():
    """Both packages' layer-name counters from zero, restored after."""
    from paddle1_tpu.nn import layer_base as jlb
    from paddle1_tpu_torch.nn import layer_base as tlb
    saved = [dict(m._global_layer_name_counts) for m in (jlb, tlb)]
    for m in (jlb, tlb):
        m._global_layer_name_counts.clear()
    yield
    for m, old in zip((jlb, tlb), saved):
        m._global_layer_name_counts.clear()
        m._global_layer_name_counts.update(old)


NAMED_LAYERS = [
    ("Linear", lambda m, kw: m.nn.Linear(4, 8, **kw)),
    ("LayerNorm", lambda m, kw: m.nn.LayerNorm(8, **kw)),
    ("Conv2D", lambda m, kw: m.nn.Conv2D(3, 4, 3, **kw)),
    ("BatchNorm2D", lambda m, kw: m.nn.BatchNorm2D(4, **kw)),
    ("TransformerEncoderLayer",
     lambda m, kw: m.nn.TransformerEncoderLayer(16, 2, 32, **kw)),
]


def test_parameter_names_are_the_references(fresh_names):
    """Each layer's parameters are named ``f"{full_name}.{attr}"`` from
    the per-class counters, in the reference's order (two Linears: the
    counter advances)."""
    for m, kw in ((jp, {}), (tp, dict(device="cpu"))):
        layers = [make(m, kw) for _, make in NAMED_LAYERS] + \
            [NAMED_LAYERS[0][1](m, kw)]
        names = [[(n, p.name) for n, p in l.named_parameters()]
                 for l in layers]
        full = [l.full_name() for l in layers]
        if m is jp:
            want = (names, full)
    assert (names, full) == want
    # the encoder layer's six Linears come between the two
    assert want[1][0] == "linear_0" and want[1][-1] == "linear_7"
    assert want[0][0] == [("weight", "linear_0.weight"),
                          ("bias", "linear_0.bias")]


def _decay_model(m, kw):
    return m.nn.Sequential(m.nn.Linear(4, 8, **kw), m.nn.LayerNorm(8, **kw),
                           m.nn.Linear(8, 3, **kw))


def _adamw_run(m, model, opt_kw, steps=3):
    """Eager AdamW steps on a fixed batch: ``(losses, optimizer)``."""
    opt = m.optimizer.AdamW(learning_rate=1e-2, parameters=model.parameters(),
                            **opt_kw)
    x = _x((5, 4), 33)
    losses = []
    for _ in range(steps):
        xt = to_tensor(x) if m is jp else tp.to_tensor(x, place="cpu")
        loss = (model(xt) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, opt


def _decay_runs(opt_kw):
    jm = _decay_model(jp, {})
    tm = _carried(jm, _decay_model(tp, dict(device="cpu")))
    with tflags.flags_guard(fused_adam="always"):
        tl, topt = _adamw_run(tp, tm, opt_kw)
    jl, jopt = _adamw_run(jp, jm, opt_kw)
    return jm, tm, jl, tl, jopt, topt


def test_decay_filter_by_name_matches_the_reference(fresh_names):
    """A filter on the name itself: the port decays exactly the
    reference's parameters (the parent named them ``param_<i>`` and so
    decayed every bias)."""
    jm, tm, jl, tl, _, _ = _decay_runs(dict(
        weight_decay=0.1, apply_decay_param_fun=lambda n: "bias" not in n))
    # losses: the forward's f32 sums in another order; parameters: the
    # JAX package's tolerance for its Adam kernel
    np.testing.assert_allclose(tl, jl, **TOL)
    for k, v in _state(jm).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_optimizer_state_dict_keys_are_the_references(fresh_names):
    jm, tm, _, _, jopt, topt = _decay_runs(dict(weight_decay=0.01))
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    assert set(tsd) == set(jsd)
    assert "linear_0.weight__moment1" in tsd and tsd["step"] == 3
    for k, v in jsd.items():
        if k != "step":
            np.testing.assert_allclose(tsd[k].numpy(), _np(v), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# F2: dropout(x, p, axis, training, mode)


def _rows_whole(out, x, scale):
    """Each row of ``out`` is all 0 or all ``x * scale``."""
    dropped = (out == 0).all(axis=1)
    kept = np.isclose(out, x * scale, rtol=1e-6, atol=0).all(axis=1)
    return bool((dropped | kept).all()), int(dropped.sum())


def test_dropout_positional_axis_drops_whole_rows():
    x = np.ones((64, 6), np.float32) * 3.0
    want = _np(jF.dropout(to_tensor(x), 0.5, 0))
    got = tF.dropout(_t(x), 0.5, 0,
                     generator=torch.Generator().manual_seed(1)).numpy()
    for out in (want, got):
        whole, dropped = _rows_whole(out, x, 2.0)
        # 64 rows at p = 0.5: none or all dropped has probability 2^-63
        assert whole and 0 < dropped < 64


def test_dropout_axis_list_broadcasts_one_mask():
    x = _x((8, 5, 6), 12)
    got = tF.dropout(_t(x), 0.4, [0, 2], True,
                     generator=torch.Generator().manual_seed(2)).numpy()
    want = _np(jF.dropout(to_tensor(x), 0.4, [0, 2], True))
    for out in (got, want):
        keep = out != 0
        # one mask of shape [8, 1, 6]: every (i, :, k) fibre kept whole
        assert (keep == keep[:, :1, :]).all()
        np.testing.assert_allclose(out[keep], (x / 0.6)[keep], rtol=1e-6)


def test_dropout_downscale_in_infer_scales_exactly():
    x = _x((4, 7), 13)
    want = _np(jF.dropout(to_tensor(x), 0.3, None, False,
                          "downscale_in_infer"))
    got = tF.dropout(_t(x), 0.3, None, False, "downscale_in_infer").numpy()
    np.testing.assert_array_equal(got, want)
    # in training the kept elements are not scaled
    d = tF.dropout(_t(x), 0.3, None, True, "downscale_in_infer",
                   generator=torch.Generator().manual_seed(3)).numpy()
    assert ((d == 0) | (d == x)).all() and (d == 0).any()


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_p_zero_is_the_identity(mode):
    t = torch.randn(5, 3)
    assert tF.dropout(t, 0.0, None, True, mode) is t
    jx = to_tensor(t.numpy())
    assert jF.dropout(jx, 0.0, None, True, mode) is jx


def test_dropout_layer_takes_axis_and_mode():
    layer = tp.nn.Dropout(0.5, 0)
    torch.manual_seed(4)
    x = np.ones((64, 6), np.float32)
    whole, dropped = _rows_whole(layer(_t(x)).numpy(), x, 2.0)
    assert whole and 0 < dropped < 64
    layer = tp.nn.Dropout(0.25, None, "downscale_in_infer").eval()
    jlayer = jp.nn.Dropout(0.25, None, "downscale_in_infer")
    jlayer.eval()
    np.testing.assert_array_equal(layer(_t(x)).numpy(),
                                  _np(jlayer(to_tensor(x))))
    with pytest.raises(InvalidArgumentError):
        tF.dropout(_t(x), 0.5, mode="scale")


# ---------------------------------------------------------------------------
# F3: the facade's max, min, sort, shape and size


@pytest.fixture
def cpu_place():
    with tp.device_guard("cpu"):
        yield


F3_REDUCTIONS = [("max", dict(axis=1)), ("min", dict(axis=0)),
                 ("max", dict()), ("min", dict(axis=[0, 1], keepdim=True)),
                 ("max", dict(axis=-1, keepdim=True)),
                 ("sort", dict(axis=1)), ("sort", dict()),
                 ("sort", dict(axis=0, descending=True))]


@pytest.mark.parametrize("method,kw", F3_REDUCTIONS,
                         ids=[f"{m}-{sorted(k.items())}"
                              for m, k in F3_REDUCTIONS])
def test_facade_reductions_return_one_tensor(cpu_place, method, kw):
    x = _x((3, 4), 14)
    want = getattr(jp.to_tensor(x), method)(**kw)
    got = getattr(tp.to_tensor(x), method)(**kw)
    assert isinstance(got, tp.Tensor)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got.shape == want.shape


def test_facade_max_gradient_matches_the_reference(cpu_place):
    x = _x((3, 4), 15)
    jx = jp.to_tensor(x, stop_gradient=False)
    (jx.max(axis=1) * 2).sum().backward()
    tx = tp.to_tensor(x, stop_gradient=False)
    (tx.max(axis=1) * 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))


def test_facade_keeps_torchs_meaning_for_torchs_arguments(cpu_place):
    x = tp.to_tensor(_x((3, 4), 16))
    values, idx = x.max(dim=1)
    assert torch.equal(idx, torch.Tensor.argmax(x, 1))
    assert isinstance(x.sort(dim=0), tuple) and \
        isinstance(x.min(dim=0, keepdim=True), tuple)
    other = tp.to_tensor(np.zeros((3, 4), np.float32))
    assert torch.equal(x.max(other), torch.maximum(x, other))
    # a plain torch tensor is untouched
    assert isinstance(torch.ones(2, 3).max(1), tuple)


def test_facade_shape_and_size_are_the_references(cpu_place):
    x = _x((2, 3), 17)
    jx, tx = jp.to_tensor(x), tp.to_tensor(x)
    assert tx.shape == [2, 3] and jx.shape == [2, 3]
    assert tx.shape == (2, 3) and tx.shape == torch.Size([2, 3])
    assert tx.shape != [3, 2] and not (tx.shape != [2, 3])
    assert list(tx.shape) == jx.shape and tx.shape.numel() == 6
    assert tx.size == jx.size == 6 and isinstance(tx.size, int)
    assert tp.to_tensor(1.5).size == jp.to_tensor(1.5).size == 1
    # called, it is torch's method
    assert tx.size() == torch.Size([2, 3]) and tx.size(1) == 3
    # torch's own code on the facade: functionals, modules, repr
    y = torch.nn.functional.max_pool2d(tp.to_tensor(_x((1, 2, 4, 4), 18)),
                                       2)
    assert y.shape == [1, 2, 2, 2] and "Tensor" in repr(tx)
    lin = torch.nn.Linear(3, 2)
    assert lin(tx).shape == [2, 2]


def test_facade_deepcopy_is_a_new_leaf_like_the_references(cpu_place):
    # found while porting YOLOv3: the port's deepcopy raised RuntimeError
    import copy
    x = _x((2, 3), 19)
    for stop in (True, False):
        jx, tx = jp.to_tensor(x, stop_gradient=stop), \
            tp.to_tensor(x, stop_gradient=stop)
        jy, ty = copy.deepcopy(jx), copy.deepcopy(tx)
        assert isinstance(ty, tp.Tensor) and ty is not tx
        assert ty.stop_gradient == jy.stop_gradient == stop
        np.testing.assert_array_equal(ty.numpy(), _np(jy))
        with torch.no_grad():
            tx.add_(1.0)
        np.testing.assert_array_equal(ty.numpy(), x)


# ---------------------------------------------------------------------------
# F4: resolve_buckets


@pytest.mark.parametrize("flags,args", [
    ({}, ()),
    ({}, ([2, 4],)),
    (dict(serve_max_batch=12), ()),
    (dict(serve_buckets="1,3,8"), ()),
    (dict(serve_buckets="1,3"), (None, 8)),
    (dict(serve_gen_prefill_buckets="16,64"),
     (None, 128, "serve_gen_prefill_buckets")),
])
def test_resolve_buckets_defaults_are_the_references(flags, args):
    from paddle1_tpu.serving.engine import resolve_buckets as jrb
    from paddle1_tpu_torch.serving.engine import resolve_buckets as trb
    with jax_flags_guard(**flags):
        want = jrb(*args)
    with tflags.flags_guard(**flags):
        got = trb(*args)
    assert got == want


def test_serving_batch_flags_are_the_references():
    from paddle1_tpu.core import flags as jflags
    for name in ("serve_max_batch", "serve_buckets"):
        assert tflags.flag(name) == jflags.flag(name)


# ---------------------------------------------------------------------------
# F7-F9: the facade's methods that share a name with torch's mean Paddle's
# call in user code (each case fails on the port before the op namespace:
# a different answer, a different type, or an error)


def _both(a):
    return jp.to_tensor(a), tp.to_tensor(a)


def test_f7_split_is_paddles_num_or_sections_then_axis(cpu_place):
    # paddle1_tpu/ops/manip_ops.py:337: x.split(3, 1) on [2, 12] is 3
    # parts of width 4; torch's reading gave 4 parts of width 3
    jx, tx = _both(_x((2, 12), 30))
    want, got = jx.split(3, 1), tx.split(3, 1)
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert b.shape == a.shape == [2, 4]
        np.testing.assert_array_equal(b.numpy(), _np(a))
    sections = tx.split([5, -1, 3], 1)
    assert [p.shape[1] for p in sections] == [5, 4, 3]


F8_CASES = [
    # math_ops.py:305: one tensor [3], the mean of the two middle values
    # (torch's x.median(1) gave (values, indices) with the lower one)
    ("median", lambda t: t.median(1)),
    ("median-all", lambda t: t.median()),
    # math_ops.py:480: (values, index); torch read True as ``sorted`` and
    # gave the values alone
    ("unique", lambda t: t.unique(True)),
]


@pytest.mark.parametrize("name,call", F8_CASES, ids=[c[0] for c in F8_CASES])
def test_f8_median_and_unique_are_the_references(cpu_place, name, call):
    a = _x((3, 4), 31)
    if name == "unique":
        a = np.round(a).astype(np.float32)
    jx, tx = _both(a)
    want, got = call(jx), call(tx)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), _np(w))
    else:
        assert isinstance(got, tp.Tensor)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["float", "bool"])
def test_f8_where_is_condition_where_x_else_y(cpu_place, kind):
    # math_ops.py:401: cond.where(x, y) is where(cond, x, y); torch's
    # reading, where(x, cond, y), raised on a float condition and on bool
    # data picked silently from the wrong tensors
    rng = np.random.default_rng(32)
    if kind == "float":
        c = (rng.random((3, 4)) < 0.5).astype(np.float32)
        x, y = _x((3, 4), 33), _x((3, 4), 34)
    else:
        c, x, y = (rng.random((3, 4)) < 0.5 for _ in range(3))
    want = _both(c)[0].where(_both(x)[0], _both(y)[0])
    got = _both(c)[1].where(_both(x)[1], _both(y)[1])
    np.testing.assert_array_equal(got.numpy(), _np(want))


F9_CASES = [
    ("transpose(perm)", lambda t, m: t.transpose([1, 0, 2]), (2, 3, 4)),
    ("unsqueeze(list)", lambda t, m: t.unsqueeze([0, 1]), (3, 4)),
    ("gather(index)", lambda t, m: t.gather(m.to_tensor(
        np.array([2, 0], np.int32))), (3, 4)),
    ("gather(index, axis)", lambda t, m: t.gather(m.to_tensor(
        np.array([3, 1], np.int32)), 1), (3, 4)),
    ("index_select(index, axis)", lambda t, m: t.index_select(m.to_tensor(
        np.array([3, 0], np.int32)), 1), (3, 4)),
    ("scatter(index, updates)", lambda t, m: t.scatter(m.to_tensor(
        np.array([1, 1], np.int32)), m.to_tensor(np.ones((2, 4),
                                                         np.float32)),
        False), (3, 4)),
    ("dot-2d", lambda t, m: t.dot(t), (3, 4)),
    ("cumsum()", lambda t, m: t.cumsum(), (3, 4)),
    ("astype", lambda t, m: t.astype("int32"), (3, 4)),
]


@pytest.mark.parametrize("name,call,shape", F9_CASES,
                         ids=[c[0] for c in F9_CASES])
def test_f9_paddle_calls_torch_refused_now_compute(cpu_place, name, call,
                                                   shape):
    # manip_ops.py:263 transpose, :316 unsqueeze, :445
    # gather, :486 scatter, math_ops.py:519 index_select, :76 dot, :318
    # cumsum, manip_ops.py:247 cast: each raised on the facade (torch's
    # method and arguments)
    jx, tx = _both(_x(shape, 35))
    want, got = call(jx, jp), call(tx, tp)
    assert isinstance(got, tp.Tensor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    assert str(got.dtype).replace("torch.", "") == np.dtype(want.dtype).name


def test_f9_numel_is_a_0d_tensor_in_user_code(cpu_place):
    # manip_ops.py:602: a 0-d int tensor (the reference's int32 is int64
    # here); the facade returned a Python int. torch's own code, which
    # calls numel() under its dispatch, still gets its int
    jx, tx = _both(_x((2, 3, 4), 36))
    n = tx.numel()
    assert isinstance(n, tp.Tensor) and n.shape == [] and \
        n.dtype == torch.int64 and int(n) == int(_np(jx.numel())) == 24
    assert tx.numel_() == 24 and tx.size == 24
    assert torch.nn.functional.dropout(tx, 0.0).shape == [2, 3, 4]
    assert torch.Tensor.numel(tx) == 24 and tx.nelement() == 24


# ---------------------------------------------------------------------------
# F10: the facade's constructor (paddle1_tpu/core/tensor.py:76)

F10_DATA = [("int", 3), ("float", 2.5), ("bool", True),
            ("int-list", [1, 2, 3]), ("float-list", [[1.0, 2.0]]),
            ("int32-array", np.arange(6, dtype=np.int32).reshape(2, 3)),
            ("float64-array", np.linspace(0, 1, 4)),
            ("float32-array", np.ones((2, 2), np.float32))]


@pytest.mark.parametrize("name,data", F10_DATA, ids=[c[0] for c in F10_DATA])
def test_f10_constructor_makes_the_references_tensor(cpu_place, name, data):
    # on the parent, Tensor(3) was torch's legacy constructor: a float32
    # [3] of uninitialized memory; Tensor(2.5) raised TypeError
    want, got = jp.Tensor(data), tp.Tensor(data)
    assert type(got) is tp.Tensor and got.is_leaf and got.stop_gradient
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), _np(want))
    kind = np.dtype(want.dtype).kind
    assert np.dtype(str(got.dtype).replace("torch.", "")).kind == kind
    if kind in "fb" or name == "int32-array":
        # ints are int64 in the port, int32 without x64 in the reference,
        # but an int32 array stays int32 in both
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)


def test_f10_constructor_keywords_are_the_references(cpu_place):
    x = np.array([1.5, -2.0], np.float32)
    want = jp.Tensor(x, dtype="float32", place="cpu", stop_gradient=False,
                     name="w0")
    got = tp.Tensor(x, "float32", "cpu", False, "w0")
    assert got.stop_gradient is want.stop_gradient is False
    assert got.name == want.name == "w0" and got.is_leaf
    assert got.place == tp.CPUPlace()
    (got * 2).sum().backward()
    np.testing.assert_array_equal(got.grad.numpy(), [2.0, 2.0])
    # a copy of a tensor's data: a new leaf, off the source's graph
    src = tp.to_tensor(x, stop_gradient=False) * 3
    new = tp.Tensor(src)
    assert new.is_leaf and new.stop_gradient and new.grad_fn is None
    src_data = src.detach()
    torch.Tensor.add_(new, 1.0)
    assert torch.equal(src.detach(), src_data)
    assert tp.Tensor(np.array([1, 2]), dtype="float32").dtype == \
        torch.float32


def test_f10_constructor_follows_the_current_place(monkeypatch):
    from paddle1_tpu_torch.core import place as tplace
    from paddle1_tpu_torch.core.errors import DeviceUnavailableError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tplace._tls, "place", None, raising=False)
    with pytest.raises(DeviceUnavailableError):
        tp.Tensor(3)                    # the default place, the card
    assert tp.Tensor(3, place="cpu").place == tp.CPUPlace()
    with tp.device_guard("cpu"):
        assert tp.Tensor(3).place == tp.CPUPlace()


def test_f10_torchs_own_ways_to_make_a_facade_still_work(cpu_place,
                                                         tmp_path):
    import copy
    import pickle
    from paddle1_tpu_torch.core.tensor import _wrap
    base = torch.arange(6.0).reshape(2, 3)
    made = [torch.Tensor._make_subclass(tp.Tensor, base, False),
            base.as_subclass(tp.Tensor), _wrap(base)]
    for t in made:
        assert type(t) is tp.Tensor and torch.equal(t, base)
    x = tp.Tensor(base.numpy(), stop_gradient=False)
    c = copy.deepcopy(x)
    assert type(c) is tp.Tensor and torch.equal(c, x) and \
        c.stop_gradient is False and c.data_ptr() != x.data_ptr()
    p = pickle.loads(pickle.dumps(tp.Tensor(base.numpy())))
    assert type(p) is tp.Tensor and torch.equal(p, base)
    path = str(tmp_path / "x.pdtensor")
    tp.save({"x": tp.Tensor(base.numpy())}, path)
    back = tp.load(path)["x"]
    assert isinstance(back, tp.Tensor) and torch.equal(back, base)
    # an op's output is a facade too, by torch's own construction
    assert type(tp.Tensor([1.0]) + 1) is tp.Tensor


# ---------------------------------------------------------------------------
# F11: layer parameters have the reference Parameter's methods
# (paddle1_tpu/core/tensor.py:242-263); torch's code keeps torch's


def _linear_pair(seed):
    jl = jp.nn.Linear(4, 6)
    with tp.utils.unique_name.guard():
        tl = tp.nn.Linear(4, 6, device="cpu")
    w = np.random.default_rng(seed).standard_normal((4, 6)).astype(
        np.float32)
    jl.weight.set_value(w)
    with torch.no_grad():
        torch.Tensor.copy_(tl.weight, torch.from_numpy(w))
    return jl.weight, tl.weight


F11_CASES = [
    ("split(3, 1)", lambda w, m: w.split(3, 1)),
    ("split([2, -1], 0)", lambda w, m: w.split([1, -1], 0)),
    ("median(0)", lambda w, m: w.median(0)),
    ("max(0)", lambda w, m: w.max(0)),
    ("min()", lambda w, m: w.min()),
    ("transpose([1, 0])", lambda w, m: w.transpose([1, 0])),
    ("astype", lambda w, m: w.astype("float64")),
    ("cast", lambda w, m: w.cast("int32")),
    ("reshape", lambda w, m: w.reshape([2, 12])),
    ("round().unique()", lambda w, m: w.round().unique()),
    ("sum(axis)", lambda w, m: w.sum(axis=1)),
    ("t()", lambda w, m: w.t()),
    ("matmul", lambda w, m: w.matmul(w.t())),
]


@pytest.mark.parametrize("name,call", F11_CASES, ids=[c[0] for c in F11_CASES])
def test_f11_parameter_methods_are_the_references(name, call):
    # on the parent, a port layer's weight kept torch's methods: split(3,
    # 1) gave 2 parts [4, 3], median(0)/max(0) (values, indices), and
    # transpose([1, 0]), astype and cast raised
    jw, tw = _linear_pair(41)
    want, got = call(jw, jp), call(tw, tp)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tp.Tensor) and g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), _np(w), rtol=1e-6,
                                   atol=1e-6)


def test_f11_parameter_metadata_and_loading_are_the_references():
    jw, tw = _linear_pair(42)
    assert tw.shape == jw.shape == [4, 6] and tw.size == jw.size == 24
    n = tw.numel()
    assert isinstance(n, tp.Tensor) and n.dim() == 0 and \
        int(n) == int(_np(jw.numel())) == 24
    assert tw.place == tp.CPUPlace() and tw.stop_gradient is False
    # numpy() of a parameter that requires grad: a copy, as the reference
    np.testing.assert_array_equal(tw.numpy(), _np(jw))
    new = np.full((4, 6), 0.25, np.float32)
    jw.set_value(new)
    assert tw.set_value(new) is tw and isinstance(tw, torch.nn.Parameter)
    np.testing.assert_array_equal(tw.numpy(), _np(jw))
    tw.set_value(tp.to_tensor(new * 2, place="cpu"))
    assert float(tw.detach().sum()) == 12.0 and tw.requires_grad
    tw.clear_grad()
    assert tw.grad is None
    # of the reference Parameter's 255 public attributes only the
    # pipeline stage and the sharding axes (later slices) are missing
    missing = [a for a in dir(jw) if not a.startswith("_") and
               not hasattr(type(tw), a) and not hasattr(tw, a)]
    assert sorted(missing) == ["pp_stage", "sharding_axes"]


def _twin_models(seed):
    """A port Linear stack, and its copy on plain ``torch.nn.Parameter``s
    (the same modules, so the same ops in the same order)."""
    import copy
    with tp.utils.unique_name.guard():
        tm = tp.nn.Sequential(tp.nn.Linear(4, 8, device="cpu"),
                              tp.nn.ReLU(), tp.nn.Linear(8, 3, device="cpu"))
    pm = copy.deepcopy(tm)
    for mod in pm.modules():
        for k, p in list(mod._parameters.items()):
            mod._parameters[k] = torch.nn.Parameter(p.detach().clone())
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (5, 4)).astype(np.float32))
    return tm, pm, x


def _same(tm, pm):
    for a, b in zip(tm.parameters(), pm.parameters()):
        assert type(b) is torch.nn.Parameter
        assert torch.equal(a.detach(), b.detach())


def test_f11_torch_optimizer_and_clip_keep_torchs_meaning():
    tm, pm, x = _twin_models(43)
    for model in (tm, pm):
        opt = torch.optim.AdamW(model.parameters(), lr=0.1)
        for _ in range(2):
            model(x).square().sum().backward()
            torch.nn.utils.clip_grad_norm_(model.parameters(), 0.5)
            opt.step()
            opt.zero_grad()
    _same(tm, pm)


def test_f11_functional_call_and_load_state_dict_keep_torchs_meaning():
    tm, pm, x = _twin_models(44)
    swapped = {k: torch.zeros_like(v) for k, v in tm.named_parameters()}
    out = torch.func.functional_call(tm, swapped, (x,))
    assert torch.equal(out, torch.zeros(5, 3))
    assert torch.equal(tm(x), pm(x))
    state = {k: v * 2 for k, v in tm.state_dict().items()}
    tm.load_state_dict(state)
    assert all(torch.equal(tm.state_dict()[k], v) for k, v in state.items())
    assert all(isinstance(p, torch.nn.Parameter) and
               not isinstance(p, tp.Tensor) for p in tm.parameters())


# ---------------------------------------------------------------------------
# F12: layers follow the current place (paddle1_tpu/core/place.py:107-121)


F12_LAYERS = [
    ("Linear", lambda m, kw: m.nn.Linear(4, 6, **kw)),
    ("Conv2D", lambda m, kw: m.nn.Conv2D(3, 4, 3, **kw)),
    ("LayerNorm", lambda m, kw: m.nn.LayerNorm(8, **kw)),
    ("BatchNorm2D", lambda m, kw: m.nn.BatchNorm2D(4, **kw)),
    ("Embedding", lambda m, kw: m.nn.Embedding(10, 4, **kw)),
    ("TransformerEncoderLayer",
     lambda m, kw: m.nn.TransformerEncoderLayer(16, 2, 32, **kw)),
    ("BertModel", lambda m, kw: m.text.models.BertModel(
        vocab_size=16, hidden_size=8, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=16, **kw)),
]


@pytest.mark.parametrize("name,make", F12_LAYERS,
                         ids=[c[0] for c in F12_LAYERS])
def test_f12_layers_follow_device_guard_cpu(name, make):
    # on the parent, every layer made without a device asked for the card
    # (DeviceUnavailableError here) whatever the current place
    with tp.device_guard("cpu"), tp.utils.unique_name.guard():
        layer = make(tp, {})
    assert all(p.device.type == "cpu" for p in layer.parameters())
    assert all(b.device.type == "cpu" for b in layer.buffers())


def test_f12_set_device_cpu_runs_a_layer_like_the_reference(monkeypatch):
    from paddle1_tpu_torch.core import place as tplace
    from paddle1_tpu_torch.core.errors import DeviceUnavailableError
    monkeypatch.setattr(tplace._tls, "place", None, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jl, x = jp.nn.Linear(4, 6), _x((3, 4), 45)
    tp.set_device("cpu")
    with tp.utils.unique_name.guard():
        tl = tp.nn.Linear(4, 6)
    tl.load_state_dict(state_from_jax(_state(jl), tl))
    got = tl(tp.to_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               _np(jl(jp.to_tensor(x))), **TOL)
    # an explicit device still wins over the current place
    with pytest.raises(DeviceUnavailableError):
        tp.nn.Linear(4, 6, device="cuda")
    # the default place stays the card: with none, a typed error, never a
    # quiet move to the CPU (a departure from the reference's fall back)
    tplace._tls.place = None
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        tp.nn.Linear(4, 6)
