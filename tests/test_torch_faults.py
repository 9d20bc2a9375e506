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
``init_parallel_env`` makes the rank's device the current place. F17:
``F.layer_norm``'s ``weight`` and ``bias`` default to None, as in the JAX
package. F18: an affine-less batch norm takes the kernels' route with ones and
zeros, and gives the JAX package's outputs and gradients; a weight or a
bias alone raises (the card's half of F18 is in
``tests/test_torch_cuda.py``).
F19: ``F.leaky_relu``'s gradient at 0 is 1, as ``jax.nn.leaky_relu``'s.
F23: ``GenerationEngine``'s ``cache_dtype`` (and ``CausalLM``'s cache
cache constructors) take the JAX package's dtype strings, ``"float16"`` included.
F24: ``ParallelEngine(amp_dtype="float16")`` is the JAX engine's pure-f16
mode, and the batch norms under it take the kernels' route in f16.
F25: ``nn.Embedding.forward`` takes the reference's ``x`` by keyword.
F26: point-to-point transfers of a device tensor over gloo raise typed
(gloo's TCP transport would be handed the device pointer).

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
    # lr_ratio is taken and left unapplied, as in the JAX package (F16)
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
    # pipeline stage (a later slice) is missing
    missing = [a for a in dir(jw) if not a.startswith("_") and
               not hasattr(type(tw), a) and not hasattr(tw, a)]
    assert sorted(missing) == ["pp_stage"]
    assert tw.sharding_axes is None is jw.sharding_axes


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


# ---------------------------------------------------------------------------
# F13: softmax and log-softmax of an integer tensor are float32, as
# jax.nn.softmax / jax.nn.log_softmax promote it in the JAX package
# (paddle1_tpu/nn/functional/activation.py:178-189); the port raised
# NotImplementedError ("softmax_lastdim_kernel_impl" not implemented for
# 'Long'). The JAX package keeps int64 as int32 (no x64 mode).

F13_CALLS = [
    ("softmax", lambda P, x, a: P.nn.functional.softmax(x, axis=a)),
    ("log_softmax", lambda P, x, a: P.nn.functional.log_softmax(x, axis=a)),
    ("softmax_", lambda P, x, a: P.nn.functional.softmax_(x, axis=a)),
    ("Softmax", lambda P, x, a: P.nn.Softmax(axis=a)(x)),
    ("LogSoftmax", lambda P, x, a: P.nn.LogSoftmax(axis=a)(x)),
]


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name,call", F13_CALLS,
                         ids=[c[0] for c in F13_CALLS])
def test_f13_softmax_of_integers_is_float32_as_the_reference(
        cpu_place, name, call, dtype, axis):
    a = np.random.default_rng(13).integers(-6, 7, size=(3, 5)).astype(dtype)
    jx, tx = _both(a)
    want, got = call(jp, jx, axis), call(tp, tx, axis)
    assert str(got.dtype) == "torch.float32" and "float32" in str(want.dtype)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-6,
                               rtol=1e-6)
    if name == "softmax_":        # the tensor itself becomes the result
        assert got is tx and tx.dtype == torch.float32
        np.testing.assert_allclose(tx.numpy(), _np(jx), atol=1e-6,
                                   rtol=1e-6)


def test_f13_integers_take_the_kernels_route_and_bool_is_refused(cpu_place):
    a = np.arange(6).reshape(2, 3)
    want = _np(jF.softmax(jp.to_tensor(a)))
    with tflags.flags_guard(fused_softmax="always"):
        got = tF.softmax(tp.to_tensor(a))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # an explicit dtype still casts first, as before
    np.testing.assert_allclose(
        tF.softmax(tp.to_tensor(a), dtype="float32").numpy(), want,
        atol=1e-6, rtol=1e-6)
    # bool is not promoted: both packages refuse it
    with pytest.raises(TypeError):
        jF.softmax(jp.to_tensor(a > 2))
    with pytest.raises((RuntimeError, NotImplementedError)):
        tF.softmax(tp.to_tensor(a > 2))


# -- F14-F16: the optimizers' reference signatures and param groups ----------

F14_OPTS = ["Optimizer", "Momentum", "Adam", "AdamW"]


@pytest.mark.parametrize("name", F14_OPTS)
def test_f14_optimizer_parameters_are_the_references_in_order(name):
    """``inspect.signature`` pins each constructor's parameters, in order,
    to the JAX package's (``name`` and ``multi_precision`` included)."""
    want = list(inspect.signature(getattr(jp.optimizer, name).__init__)
                .parameters)
    got = list(inspect.signature(getattr(tp.optimizer, name).__init__)
               .parameters)
    assert got == want


def test_f14_momentum_takes_multi_precision_and_name_positionally():
    """``Momentum(0.1, 0.9, ps, False, None, None, True, "m")``: the
    seventh argument is ``multi_precision`` and the eighth ``name``, in
    both packages; the velocity is f32 for a bf16 parameter, the meaning
    of ``multi_precision``."""
    w = torch.nn.Parameter(torch.ones(2, dtype=torch.bfloat16))
    opt = tp.optimizer.Momentum(0.1, 0.9, [w], False, None, None, True, "m")
    w.grad = torch.ones(2, dtype=torch.bfloat16)
    opt.step()
    assert opt._slots_for(w)["velocity"].dtype == torch.float32
    assert torch.equal(w.detach(), torch.full((2,), 0.9, dtype=w.dtype))
    tp.optimizer.Optimizer(0.1, [w], None, None, "o", True)


def _f15_layers(fresh):
    jp.seed(15)
    jl = jp.nn.Linear(4, 3)
    tl = tp.nn.Linear(4, 3, device="cpu")
    tl.load_state_dict(state_from_jax(_state(jl), tl))
    return jl, tl


def _f15_steps(m, layer, opt, xs):
    for x in xs:
        xt = jp.to_tensor(x) if m is jp else _t(x)
        (layer(xt) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()


F15_OPTS = [("Momentum", dict(momentum=0.9)), ("Adam", {}), ("AdamW", {})]


@pytest.mark.parametrize("fused", ["never", "always"])
@pytest.mark.parametrize("name,kw", F15_OPTS, ids=[o[0] for o in F15_OPTS])
def test_f15_param_groups_step_like_the_reference(fresh_names, name, kw,
                                                  fused):
    """Param groups with a per-group ``learning_rate``: the weight at
    half the rate, the bias at the optimizer's; three eager steps match
    the JAX package's within 1e-6 (on the fused route too, whose table
    carries the group's rate)."""
    jl, tl = _f15_layers(fresh_names)
    rng = np.random.default_rng(15)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    for m, layer in ((jp, jl), (tp, tl)):
        opt = getattr(m.optimizer, name)(
            learning_rate=0.01, parameters=[
                {"params": [layer.weight], "learning_rate": 0.5},
                {"params": [layer.bias]}], **kw)
        with tflags.flags_guard(fused_adam=fused):
            _f15_steps(m, layer, opt, xs)
    assert tl.weight.optimize_attr["learning_rate"] == 0.5
    for k, v in _state(jl).items():
        np.testing.assert_allclose(tl.state_dict()[k].detach().numpy(), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fused", ["never", "always"])
@pytest.mark.parametrize("name", ["Momentum", "Adam", "AdamW"])
def test_f15_a_group_weight_decay_replaces_the_optimizers(fresh_names, name,
                                                          fused):
    """A group's ``weight_decay`` reaches ``optimize_attr`` in both
    packages. The port applies it in place of the optimizer's (as
    Paddle's reference does): the run equals one whose optimizer has that
    decay, on the fused route too; the JAX package records it and reads
    it nowhere, so its run equals one without the group's decay."""
    rng = np.random.default_rng(16)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(2)]
    runs = []
    for groups in (True, False):
        jl, tl = _f15_layers(fresh_names)
        for m, layer in ((jp, jl), (tp, tl)):
            params = [{"params": [layer.weight, layer.bias],
                       "weight_decay": 0.3}] if groups else \
                layer.parameters()
            wd = 0.0 if groups else (0.3 if m is tp else 0.0)
            opt = getattr(m.optimizer, name)(
                learning_rate=0.01, parameters=params, weight_decay=wd)
            with tflags.flags_guard(fused_adam=fused):
                _f15_steps(m, layer, opt, xs)
        if groups:
            assert tl.weight.optimize_attr["weight_decay"] == 0.3
            assert jl.weight.optimize_attr["weight_decay"] == 0.3
        runs.append((_state(jl), {k: v.detach().numpy()
                                  for k, v in tl.state_dict().items()}))
    (jg, tg), (jn, tn) = runs
    for k in jg:
        np.testing.assert_array_equal(jg[k], jn[k], err_msg=k)
        np.testing.assert_allclose(tg[k], tn[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert any(not np.allclose(tg[k], jg[k], atol=1e-6) for k in jg)


@pytest.mark.parametrize("fused", ["never", "always"])
def test_f16_adamw_takes_lr_ratio_and_leaves_it_unapplied(fresh_names,
                                                           fused):
    """``AdamW(lr_ratio=...)`` constructs and its steps equal the JAX
    package's with the same ``lr_ratio``, which neither package applies
    (the steps also equal a run without it)."""
    rng = np.random.default_rng(17)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    jl, tl = _f15_layers(fresh_names)
    for m, layer in ((jp, jl), (tp, tl)):
        opt = m.optimizer.AdamW(0.01, parameters=layer.parameters(),
                                lr_ratio=lambda p: 0.25)
        with tflags.flags_guard(fused_adam=fused):
            _f15_steps(m, layer, opt, xs)
    for k, v in _state(jl).items():
        np.testing.assert_allclose(tl.state_dict()[k].detach().numpy(), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# F17: F.layer_norm(x, normalized_shape) with weight and bias defaulted


F17_AFFINE = ["both", "weight", "bias", "none"]


@pytest.mark.parametrize("affine", F17_AFFINE)
def test_f17_layer_norm_weight_and_bias_default_to_none(cpu_place, affine):
    """``layer_norm(x, normalized_shape, weight=None, bias=None, epsilon,
    name)`` is the JAX signature (``norm.py:352``), and each combination
    of the halves, passed by keyword or left out, gives the JAX package's
    values and gradients; a missing half is the JAX call's explicit ones
    or zeros (the JAX package itself raises on a weight without a bias and
    drops a bias without a weight: ROADMAP, by design). 1e-5 abs/rel."""
    jsig = inspect.signature(jF.layer_norm)
    tsig = inspect.signature(tF.layer_norm)
    assert [(p.name, p.default) for p in tsig.parameters.values()] == \
        [(p.name, p.default) for p in jsig.parameters.values()]
    rng = np.random.default_rng(170)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    kw = {"both": dict(weight=w, bias=b), "weight": dict(weight=w),
          "bias": dict(bias=b), "none": {}}[affine]
    full = {"weight": w if "weight" in kw else np.ones(8, np.float32),
            "bias": b if "bias" in kw else np.zeros(8, np.float32)}

    def leaf(m, a):
        t = m.to_tensor(a)
        t.stop_gradient = False
        return t
    jx, tx = leaf(jp, x), leaf(tp, x)
    jkw = {k: leaf(jp, v) for k, v in full.items()}
    tkw = {k: leaf(tp, v) for k, v in kw.items()}
    jy = jF.layer_norm(jx, 8, **(jkw if affine != "none" else {}))
    ty = tF.layer_norm(tx, 8, **tkw)
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **TOL)
    wsum = rng.standard_normal(x.shape).astype(np.float32)
    (jy * jp.to_tensor(wsum)).sum().backward()
    (ty * tp.to_tensor(wsum)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **TOL)
    for k, t in tkw.items():
        np.testing.assert_allclose(t.grad.numpy(), _np(jkw[k].grad), **TOL,
                                   err_msg=k)


def test_f17_layer_norm_layer_without_affine_halves(cpu_place, fresh_names):
    """``nn.LayerNorm(..., weight_attr=False, bias_attr=False)`` calls
    ``F.layer_norm`` with neither half and agrees with the JAX package."""
    x = np.random.default_rng(171).standard_normal((4, 6)).astype(np.float32)
    jl = jp.nn.LayerNorm(6, weight_attr=False, bias_attr=False)
    tl = tp.nn.LayerNorm(6, weight_attr=False, bias_attr=False)
    np.testing.assert_allclose(tl(tp.to_tensor(x)).numpy(),
                               _np(jl(jp.to_tensor(x))), **TOL)


# F18: affine-less batch norm through the kernels' wrappers


@pytest.mark.parametrize("flags", ["kernels", "plain"])
@pytest.mark.parametrize("layer", ["BatchNorm1D", "BatchNorm2D",
                                   "BatchNorm3D"])
def test_f18_affine_less_batch_norm_matches_the_reference(cpu_place,
                                                         fresh_names, flags,
                                                         layer):
    """``BatchNorm*D(C, weight_attr=False, bias_attr=False)``: a training
    forward, its input gradient, the running statistics, then an eval
    forward, against the JAX package (1e-5 abs/rel); under ``kernels``
    (``conv_nhwc``/``fused_bn``/``fused_bn_bwd`` ``always``) through the
    kernels' wrappers with gamma ones and beta zeros, which on the card
    launch rows 8, 11 and 9."""
    shape = {"BatchNorm1D": (4, 8, 6), "BatchNorm2D": (2, 8, 3, 3),
             "BatchNorm3D": (2, 8, 2, 3, 3)}[layer]
    rng = np.random.default_rng(180)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    wsum = rng.standard_normal(shape).astype(np.float32)
    jl = getattr(jp.nn, layer)(8, weight_attr=False, bias_attr=False)
    tl = getattr(tp.nn, layer)(8, weight_attr=False, bias_attr=False)
    assert tl.weight is None and tl.bias is None and \
        not list(tl.parameters())
    mode = "always" if flags == "kernels" else "never"
    jx, tx = jp.to_tensor(x), tp.to_tensor(x)
    jx.stop_gradient = tx.stop_gradient = False
    jy = jl(jx)
    with tflags.flags_guard(conv_nhwc=mode, fused_bn=mode, fused_bn_bwd=mode):
        ty = tl(tx)
        (ty * tp.to_tensor(wsum)).sum().backward()
        tl.eval()
        te = tl(tp.to_tensor(x))
    (jy * jp.to_tensor(wsum)).sum().backward()
    jl.eval()
    je = jl(jp.to_tensor(x))
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **TOL)
    np.testing.assert_allclose(te.detach().numpy(), _np(je), **TOL)
    for k, v in _state(jl).items():
        np.testing.assert_allclose(tl.state_dict()[k].numpy(), v, **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("flags", ["kernels", "plain"])
@pytest.mark.parametrize("op", ["batch_norm", "instance_norm",
                                "group_norm"])
@pytest.mark.parametrize("half", ["weight", "bias"])
def test_f18_half_affine_norm_raises(cpu_place, flags, op, half):
    """A batch, instance or group norm given its weight alone or its bias
    alone raises, under either flag set. The JAX package takes the affine
    both or neither too: it raises on the weight alone and drops the bias
    alone (ROADMAP, by design: the port raises there)."""
    rng = np.random.default_rng(181)
    x = (rng.standard_normal((2, 8, 3, 3)) * 2 + 0.5).astype(np.float32)
    v = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    def call(pkg, x, w, b):
        F = pkg.nn.functional
        if op == "batch_norm":
            return F.batch_norm(x, pkg.to_tensor(np.zeros(8, np.float32)),
                                pkg.to_tensor(np.ones(8, np.float32)), w, b,
                                training=True)
        if op == "instance_norm":
            return F.instance_norm(x, weight=w, bias=b)
        return F.group_norm(x, 4, weight=w, bias=b)
    mode = "always" if flags == "kernels" else "never"
    tx, p = tp.to_tensor(x), tp.to_tensor(v)
    args = (p, None) if half == "weight" else (None, p)
    with tflags.flags_guard(conv_nhwc=mode, fused_bn=mode,
                            fused_bn_bwd=mode):
        with pytest.raises(InvalidArgumentError, match=f"only the {half}"):
            call(tp, tx, *args)
    jx, jv = jp.to_tensor(x), jp.to_tensor(v)
    if half == "weight":
        with pytest.raises(Exception):
            call(jp, jx, jv, None)
    else:
        np.testing.assert_allclose(_np(call(jp, jx, None, jv)),
                                   _np(call(jp, jx, None, None)), **TOL)


# F19: F.leaky_relu's gradient at x == 0


@pytest.mark.parametrize("slope", [0.01, 0.2])
def test_f19_leaky_relu_gradient_at_zero_is_the_reference_s(cpu_place,
                                                            slope):
    """``jax.nn.leaky_relu`` is ``where(x >= 0, x, slope * x)``: its
    gradient at 0 is 1 (torch's is the slope); values and gradients
    elsewhere unchanged, exact."""
    x = np.array([0.0, -1.5, 2.0, -0.0], np.float32)
    jx, tx = jp.to_tensor(x), tp.to_tensor(x)
    jx.stop_gradient = tx.stop_gradient = False
    jy, ty = jF.leaky_relu(jx, slope), tF.leaky_relu(tx, slope)
    np.testing.assert_array_equal(ty.detach().numpy(), _np(jy))
    (jy * jp.to_tensor(np.arange(1, 5, dtype=np.float32))).sum().backward()
    (ty * tp.to_tensor(np.arange(1, 5, dtype=np.float32))).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))
    np.testing.assert_array_equal(tx.grad.numpy()[[0, 3]], [1.0, 4.0])


# ---------------------------------------------------------------------------
# F20: negative-step slices, read and written, as numpy's (the reference's)

F20_INDICES = [np.s_[::-1], np.s_[:, ::-2], np.s_[..., ::-1],
               np.s_[1, 2:0:-1], np.s_[None, ::-1, 1], np.s_[::-1, [0, 2]],
               np.s_[5:0:-1], np.s_[0:2:-1]]
F20_IDS = ["rev", "col-step2", "last-axis-flip", "int-then-rev",
           "none-rev-int", "rev-then-list", "start-past-end", "empty"]


@pytest.mark.parametrize("idx", F20_INDICES, ids=F20_IDS)
def test_f20_negative_step_slice_reads_like_the_reference(cpu_place, idx):
    x = _x((3, 4, 5), 200)
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jo, to = jx[idx], tx[idx]
    np.testing.assert_array_equal(_np(to), _np(jo))
    w = _x(tuple(_np(jo).shape), 201)
    (jo * jp.to_tensor(w)).sum().backward()
    (to * tp.to_tensor(w)).sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))


@pytest.mark.parametrize("idx", F20_INDICES, ids=F20_IDS)
def test_f20_negative_step_slice_assigns_like_the_reference(cpu_place, idx):
    x = _x((3, 4, 5), 202)
    shape = np.asarray(x[idx]).shape
    v = _x(shape, 203)
    # a constant, a tensor value, and a tensor value with a gradient
    jx, tx = jp.to_tensor(x), tp.to_tensor(x)
    jx[idx], tx[idx] = 0.5, 0.5
    np.testing.assert_array_equal(_np(tx), _np(jx))
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jv = jp.to_tensor(v, stop_gradient=False)
    tv = tp.to_tensor(v, stop_gradient=False)
    jy, ty = jx * 2.0, tx * 2.0
    jy[idx], ty[idx] = jv, tv
    np.testing.assert_array_equal(_np(ty), _np(jy))
    w = _x((3, 4, 5), 204)
    (jy * jp.to_tensor(w)).sum().backward()
    (ty * tp.to_tensor(w)).sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
    np.testing.assert_array_equal(_np(tv.grad), _np(jv.grad))


def test_f20_negative_step_on_a_leaf_and_a_parameter(cpu_place,
                                                     fresh_names):
    x = _x((4, 3), 205)
    # a leaf that requires grad is rebound, as the reference rebinds
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jx[::-1, 0] = 0.0
    tx[::-1, 0] = 0.0
    np.testing.assert_array_equal(_np(tx), _np(jx))
    jl, tl = jp.nn.Linear(4, 3), tp.nn.Linear(4, 3)
    _carried(jl, tl)
    # a parameter's ops are torch's: a plain tensor, as w[1:] gives
    np.testing.assert_array_equal(tl.weight[::-1].detach().numpy(),
                                  _np(jl.weight[::-1]))
    jl.weight[..., ::-2] = 1.0
    tl.weight[..., ::-2] = 1.0
    np.testing.assert_array_equal(_np(tl.weight), _np(jl.weight))


@pytest.mark.parametrize("idx", [np.s_[1:3], np.s_[[0, 2]], np.s_[:, 1],
                                 np.s_[..., None]], ids=str)
def test_f20_positive_and_advanced_indices_keep_torchs_path(cpu_place, idx):
    x = _x((3, 4), 206)
    tx = tp.to_tensor(x)
    np.testing.assert_array_equal(_np(tx[idx]), x[idx])
    mask = x > 0
    np.testing.assert_array_equal(_np(tx[tp.to_tensor(mask)]), x[mask])


# ---------------------------------------------------------------------------
# F21: a shape adds to a list as the reference's list does


F21_IDIOMS = [
    ("slice-plus-list", lambda s: s[:-1] + [2, 5]),
    ("plus-list", lambda s: s + [1]),
    ("list-plus-slice", lambda s: [6] + s[1:]),
    ("slice", lambda s: s[1:]),
    ("step-slice", lambda s: s[::-1]),
    ("slice-plus-slice", lambda s: s[:1] + s[1:]),
]


@pytest.mark.parametrize("name,idiom", F21_IDIOMS,
                         ids=[i[0] for i in F21_IDIOMS])
def test_f21_shape_arithmetic_gives_the_references_list(cpu_place, name,
                                                        idiom):
    x = _x((3, 4, 10), 210)
    want = idiom(jp.to_tensor(x).shape)
    got = idiom(tp.to_tensor(x).shape)
    assert isinstance(want, list)
    assert got == want and list(got) == want


def test_f21_shape_idioms_reshape_like_the_reference(cpu_place,
                                                     fresh_names):
    x = _x((2, 3, 10), 211)
    jx, tx = jp.to_tensor(x), tp.to_tensor(x)
    for fn in (lambda m, t: t.reshape(t.shape[:-1] + [2, 5]),
               lambda m, t: m.reshape(t, t.shape + [1]),
               lambda m, t: m.reshape(t, [6] + t.shape[2:])):
        np.testing.assert_array_equal(_np(fn(tp, tx)), _np(fn(jp, jx)))
    w = tp.nn.Linear(4, 6).weight
    assert w.shape[:1] + [2, 3] == [4, 2, 3]
    # torch's own code still reads a tuple
    assert tuple(tx.shape) == (2, 3, 10) and isinstance(tx.shape, tuple)
    assert torch.zeros(tx.shape).shape == (2, 3, 10)
    assert tx.shape + (1,) == (2, 3, 10, 1)


def test_f21_shape_item_assignment_is_a_departure(cpu_place):
    """By design (ROADMAP Queue 3): a shape is a tuple, so assigning into
    it raises where the reference's list takes the item."""
    x = _x((2, 3), 212)
    js = jp.to_tensor(x).shape
    js[0] = 5
    assert js == [5, 3]
    ts = tp.to_tensor(x).shape
    with pytest.raises(TypeError):
        ts[0] = 5
    ts = list(ts)       # the port's way
    ts[0] = 5
    assert ts == js


# ---------------------------------------------------------------------------
# F22: a dtype is torch's; the comparisons the reference's numpy dtype
# answers are pinned here (ROADMAP Queue 3, a departure by design)


def test_f22_dtype_against_strings_and_numpy_is_a_departure(cpu_place):
    x = _x((2,), 220)
    jd, td = jp.to_tensor(x).dtype, tp.to_tensor(x).dtype
    # the reference: a numpy dtype
    assert jd == "float32" and jd == np.float32
    assert jd in ("float32", "float16")
    assert np.zeros(2, dtype=jd).dtype == np.float32
    # the port: torch's dtype, equal to the port's names and to torch's
    assert td == tp.float32 == torch.float32
    assert td != "float32" and td != np.float32
    assert td not in ("float32", "float16")
    with pytest.raises(TypeError):
        np.zeros(2, dtype=td)
    # the port's spellings of the same tests
    from paddle1_tpu_torch.core.dtype import convert_dtype
    assert convert_dtype("float32") == td
    assert str(td).replace("torch.", "") == "float32"
    assert tp.to_tensor(x).astype("float32").dtype == td
    assert np.zeros(2, dtype=tp.to_tensor(x).numpy().dtype).dtype == \
        np.float32


# ---------------------------------------------------------------------------
# F23: cache_dtype takes the JAX package's dtype strings (the reference
# spells it "float32"; the port raised on any string)


@pytest.fixture(scope="module")
def f23_lm_pair():
    from paddle1_tpu.serving import CausalLM as JCausalLM
    from paddle1_tpu_torch.serving import CausalLM
    jp.seed(23)
    jl = JCausalLM(48, d_model=32, nhead=2, dim_feedforward=64,
                   num_layers=2, max_seq=48)
    tl = CausalLM(48, d_model=32, nhead=2, dim_feedforward=64,
                  num_layers=2, max_seq=48, device="cpu")
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    tl.load_state_dict(state_from_jax(state, tl))
    return jl, tl


@pytest.mark.parametrize("paged", [True, False])
def test_f23_float16_cache_serves_the_references_greedy_tokens(
        f23_lm_pair, paged):
    from paddle1_tpu.serving import GenerationEngine as JEngine
    from paddle1_tpu.serving import GenerationServer as JServer
    from paddle1_tpu_torch.serving import GenerationEngine, GenerationServer
    jl, tl = f23_lm_pair
    prompts = [[1, 5, 3], [2, 2, 9, 4, 4, 7], [7, 1, 4, 9, 6], [3, 3]]
    kw = dict(slots=4, max_seq=48, prefill_buckets=(8, 16), paged=paged,
              page_size=8, cache_dtype="float16")
    jsrv = JServer(JEngine(jl, **kw), token_budget=12).start()
    want = [s.result(timeout=120) for s in
            [jsrv.submit(p, max_new_tokens=10) for p in prompts]]
    jsrv.drain()
    eng = GenerationEngine(tl, **kw)
    assert all(k.dtype == v.dtype == torch.float16 for k, v in eng._kv)
    srv = GenerationServer(eng, token_budget=12).start()
    got = [s.result(timeout=120) for s in
           [srv.submit(p, max_new_tokens=10) for p in prompts]]
    rep = srv.drain()
    assert got == want
    assert rep["unaccounted"] == 0 and rep["tokens_owed"] == 0


@pytest.mark.parametrize("spelling,dtype", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16),
    ("float16", torch.float16), (torch.float16, torch.float16)])
def test_f23_cache_constructors_take_the_references_strings(f23_lm_pair,
                                                        spelling, dtype):
    _, tl = f23_lm_pair
    for c in (tl.gen_slot_cache(2, 8, spelling)[0],
              tl.gen_paged_cache(3, 4, spelling)[0]):
        assert c.k.dtype == c.v.dtype == dtype
    assert tl.gen_slot_cache(2, 8)[0].k.dtype == torch.float32


def test_f23_other_cache_dtypes_raise_typed(f23_lm_pair):
    from paddle1_tpu_torch.serving import GenerationEngine
    _, tl = f23_lm_pair
    for bad in ("int8", "float64", "floaty"):
        with pytest.raises(InvalidArgumentError):
            GenerationEngine(tl, slots=2, max_seq=16, cache_dtype=bad)


# ---------------------------------------------------------------------------
# F24: the engine's pure-float16 mode


def _f24_pair():
    """Conv2D(3, 8, 3) + BatchNorm2D(8) + a Linear head, both packages,
    one state."""
    from paddle1_tpu.nn import Linear as JLin
    from paddle1_tpu.nn.layer_conv_pool import Conv2D as JConv
    from paddle1_tpu.nn.layer_norm_act import BatchNorm2D as JBN
    from paddle1_tpu.nn.layer_norm_act import Sequential as JSeq

    class JNet(JSeq):
        def forward(self, x):
            return self[2](self[1](self[0](x)).mean(axis=[2, 3]))

    class TNet(tp.nn.Sequential):
        def forward(self, x):
            return self[2](self[1](self[0](x)).mean(dim=(2, 3)))
    jp.seed(24)
    jn = JNet(JConv(3, 8, 3), JBN(8), JLin(8, 4))
    with tp.utils.unique_name.guard():
        tn = TNet(tp.nn.Conv2D(3, 8, 3, device="cpu"),
                  tp.nn.BatchNorm2D(8, device="cpu"),
                  tp.nn.Linear(8, 4, device="cpu"))
    _carried(jn, tn)
    return jn, tn


def _f24_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, 3, 10, 10)).astype(np.float32),
            "y": rng.integers(0, 4, (4,)).astype(np.int64)}


F24_STEPS = 3
F24_KERNELS = dict(conv_nhwc="always", fused_bn="always",
                   fused_bn_bwd="always")
F24_PLAIN = dict(conv_nhwc="never", fused_bn="never", fused_bn_bwd="never")


@pytest.fixture(scope="module")
def f24_jax_run():
    from paddle1_tpu.core.tensor import Tensor as JTensor
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh
    import jax
    jn, tn = _f24_pair()
    jn.train()
    jeng = JEngine(jn, jp.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jn.parameters()),
        lambda m, b: jF.cross_entropy(m(JTensor(b["x"])), JTensor(b["y"])),
        mesh=build_mesh(dp=1, devices=[jax.devices()[0]]),
        amp_dtype="float16")
    losses = [float(jeng.step(_f24_batch(s))) for s in range(F24_STEPS)]
    return tn.state_dict(), losses, {k: np.asarray(v)
                                     for k, v in jeng.params.items()}


@pytest.mark.parametrize("flags", [F24_PLAIN, F24_KERNELS],
                         ids=["plain", "kernel"])
def test_f24_float16_engine_trains_like_the_reference(f24_jax_run, flags):
    """Three Momentum steps under ``amp_dtype="float16"`` in both engines
    (no loss scaler in either). Losses and every parameter and running
    statistic within one f16 step (2^-10, relative, or absolute near 0):
    each package rounds its f16 forward and backward at other places
    (the JAX package's f16 conv sums in another order), and the f32
    masters take those f16 gradients times lr = 0.1."""
    state0, jlosses, jparams = f24_jax_run
    _, tn = _f24_pair()
    tn.load_state_dict(state0)
    tn.train()
    eng = tp.distributed.ParallelEngine(
        tn, tp.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=tn.parameters()),
        lambda m, b: tF.cross_entropy(m(b["x"]), b["y"]),
        amp_dtype="float16")
    assert eng.amp_dtype == torch.float16
    with tflags.flags_guard(**flags):
        losses = [float(eng.step(_f24_batch(s))) for s in range(F24_STEPS)]
    assert all(np.isfinite(losses))
    step = 2.0 ** -10
    np.testing.assert_allclose(losses, jlosses, atol=step, rtol=step)
    state = tn.state_dict()
    assert set(state) == set(jparams)
    for name, t in state.items():
        assert t.dtype == torch.float32, name      # masters stay f32
        np.testing.assert_allclose(t.numpy(), jparams[name], err_msg=name,
                                   atol=step, rtol=step)


def test_f24_float16_batch_norm_takes_the_kernels_route(monkeypatch):
    """Under the f16 engine a training batch norm hands the kernels'
    wrapper f16 rows and f16 gamma/beta: f16 is inside the kernels'
    contract, as the Pallas kernels' 16-bit gate has it."""
    from paddle1_tpu_torch.ops import fused_bn as tbn
    _, tn = _f24_pair()
    tn.train()
    seen = []
    orig = tbn.fused_bn_train
    monkeypatch.setattr(tbn, "fused_bn_train", lambda x2, g, b, *a, **k: (
        seen.append((x2.dtype, g.dtype)), orig(x2, g, b, *a, **k))[1])
    eng = tp.distributed.ParallelEngine(
        tn, tp.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  parameters=tn.parameters()),
        lambda m, b: tF.cross_entropy(m(b["x"]), b["y"]),
        amp_dtype="float16")
    with tflags.flags_guard(**F24_KERNELS):
        assert np.isfinite(float(eng.step(_f24_batch(0))))
    assert seen == [(torch.float16, torch.float16)]
    assert tbn.supported((4, 8), torch.float16)
    assert not tbn.supported((4, 8), torch.float64)


def test_f24_other_amp_dtypes_raise_typed():
    _, tn = _f24_pair()
    for bad in ("float64", "int8", "half"):
        with pytest.raises(InvalidArgumentError):
            tp.distributed.ParallelEngine(
                tn, tp.optimizer.Momentum(learning_rate=0.1,
                                          parameters=tn.parameters()),
                lambda m, b: m(b["x"]).sum(), amp_dtype=bad)


# ---------------------------------------------------------------------------
# F25: nn.Embedding.forward(x), as paddle1_tpu/nn/layer_common.py:125


def test_f25_embedding_forward_takes_x_by_keyword():
    ids = np.array([[1, 2], [3, 0]], np.int64)
    jp.seed(25)
    jemb = jp.nn.Embedding(5, 3)
    want = np.asarray(jemb(x=to_tensor(ids)).numpy())
    assert want.shape == (2, 2, 3)
    with tp.utils.unique_name.guard():
        temb = tp.nn.Embedding(5, 3, device="cpu")
    temb.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jemb.functional_state().items()},
        temb))
    got = temb(x=_t(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert list(inspect.signature(tp.nn.Embedding.forward).parameters) == \
        list(inspect.signature(jp.nn.Embedding.forward).parameters)


def test_f26_gloo_refuses_point_to_point_of_device_tensors():
    """On the card gloo hands its TCP transport a CUDA tensor's device
    pointer (``send``/``recv`` fail with ``writev ... Bad address``,
    ``isend``/``irecv`` abort the process:
    ``tools/torch_hybrid_phases.py --gloo-probe``); the port refuses a
    tensor off the CPU over gloo before any transfer, typed. A meta tensor
    stands in for a card's here."""
    import datetime
    import torch.distributed as dist
    from paddle1_tpu_torch.core.errors import UnavailableError
    from paddle1_tpu_torch.distributed import collective as C
    pg = dist.ProcessGroupGloo(dist.HashStore(), 0, 1,
                               datetime.timedelta(seconds=30))
    g = C.Group(0, 2, ranks=[0, 1], process_group=pg)
    t = torch.empty(4, device="meta")
    for fn, peer in ((C.send, "dst"), (C.recv, "src"), (C.isend, "dst"),
                     (C.irecv, "src")):
        with pytest.raises(UnavailableError, match="gloo moves only CPU"):
            fn(t, **{peer: 1}, group=g)
