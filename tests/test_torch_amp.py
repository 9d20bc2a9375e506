"""Automatic mixed precision in the PyTorch port against the JAX package.

``paddle1_tpu_torch.amp`` casts at the boundary of a named Paddle op,
under the JAX package's op names (its module docstring states the
design). Held here on the CPU, inputs and weights from numpy with a seed:

- the lists and ``__all__`` are the JAX package's;
- every listed op the port has gives, under ``auto_cast`` in bf16 and
  f16, the JAX package's output dtype, and values within a tolerance from
  the AMP dtype's rounding step (below);
- the ``(name, output dtype)`` sequence of the listed ops in a narrow BERT
  classifier's forward equals the JAX package's (both cast points
  monkeypatched), and so does the forward loss within that tolerance;
- gradients: equal to the port's own explicit-cast torch computation,
  and within the tolerance of the JAX package's where its backward runs
  (logits cast to float32 before the loss, ``tests/test_training_e2e.py``'s
  pattern), its bf16 gradients cast to float32 first;
- the two departures by design, each beside the JAX package's behaviour:
  the backward through a black-listed op runs (the JAX package's raises),
  and an f32 parameter's gradient is f32 (the JAX package's is bf16);
- ``GradScaler``'s state machine against the JAX package's over seeded
  sequences of finite and non-finite steps through ``unscale_``, ``step``,
  ``update``, ``minimize`` and ``record_step``;
- ``decorate``'s dtypes and shapes, nesting, threads, ``O0`` and the
  custom lists.

Tolerance of a low-precision result: its inputs are rounded to the AMP
dtype identically in both packages, so the outputs differ by the
rounding of the output and of the partial sums, a few steps of the
dtype's unit roundoff ``u`` (2^-8 for bf16, 2^-11 for f16):
``atol = 4 u max|want|``, ``rtol = 4 u``. float32 results of black-listed
ops take f32's 1e-5.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core.tensor import to_tensor
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.errors import InvalidArgumentError

jF = jp.nn.functional
tF = tp.nn.functional
UNIT = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
F32_TOL = dict(rtol=1e-5, atol=1e-6)
CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
B, S = 4, 16


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.functional_state().items()}


def _f32(t):
    """A tensor of either package as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.astype("float32").numpy())


def _dtype(t):
    return str(t.dtype).replace("torch.", "").replace("paddle.", "")


def _close_lowp(got, want, amp_dtype, what=""):
    u = UNIT[amp_dtype]
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=4 * u,
                               atol=4 * u * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.fixture
def fresh_names():
    from paddle1_tpu.nn import layer_base as jlb
    from paddle1_tpu_torch.nn import layer_base as tlb
    saved = [dict(m._global_layer_name_counts) for m in (jlb, tlb)]
    for m in (jlb, tlb):
        m._global_layer_name_counts.clear()
    yield
    for m, old in zip((jlb, tlb), saved):
        m._global_layer_name_counts.clear()
        m._global_layer_name_counts.update(old)


def test_the_names_and_lists_are_the_references():
    assert sorted(tp.amp.__all__) == sorted(jp.amp.__all__)
    assert tp.amp.WHITE_LIST == jp.amp.WHITE_LIST
    assert tp.amp.BLACK_LIST == jp.amp.BLACK_LIST
    assert tp.amp.amp_guard is tp.amp.auto_cast


# -- every listed op the port has --------------------------------------------

def _arrays():
    rng = np.random.default_rng(19)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(a34=f(3, 4), b45=f(4, 5), a234=f(2, 3, 4), b245=f(2, 4, 5),
                v4=f(4), i35=f(3, 5), b5=f(5), x=f(3, 4),
                pos=rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
                img=f(1, 2, 5, 5), k=f(3, 2, 3, 3), b3=f(3), w4=f(4),
                bn=f(4, 3, 2, 2), rm=f(3) * 0.1, rv=rng.uniform(
                    0.5, 1.5, 3).astype(np.float32), g3=f(3),
                labels=np.array([0, 3, 1], np.int64))


def _bn(F, T, fused, training):
    def call(a, r):
        args = (T(a["bn"]), r(a["rm"]), r(a["rv"]), T(a["g3"]), T(a["b3"]))
        if fused:
            return F.fused_batch_norm_act(*args, training=training,
                                          act="relu")
        return F.batch_norm(*args, training=training)
    return call


# (name, white?, call(m, F, T, a, r)); T makes an input in the dtype the
# case gives, r an f32 tensor (labels and running statistics)
OPS = [
    ("matmul", True, lambda m, F, T, a, r: m.matmul(T(a["a34"]),
                                                    T(a["b45"]))),
    ("bmm", True, lambda m, F, T, a, r: m.bmm(T(a["a234"]), T(a["b245"]))),
    ("mv", True, lambda m, F, T, a, r: m.mv(T(a["a34"]), T(a["v4"]))),
    ("addmm", True, lambda m, F, T, a, r: m.addmm(T(a["i35"]), T(a["a34"]),
                                                  T(a["b45"]))),
    ("einsum", True, lambda m, F, T, a, r: m.einsum(
        "ij,jk->ik", T(a["a34"]), T(a["b45"]))),
    ("linear", True, lambda m, F, T, a, r: F.linear(T(a["a34"]), T(a["b45"]),
                                                    T(a["b5"]))),
    ("conv2d", True, lambda m, F, T, a, r: F.conv2d(T(a["img"]), T(a["k"]),
                                                    T(a["b3"]), padding=1)),
    ("exp", False, lambda m, F, T, a, r: m.exp(T(a["x"]))),
    ("log", False, lambda m, F, T, a, r: m.log(T(a["pos"]))),
    ("log2", False, lambda m, F, T, a, r: m.log2(T(a["pos"]))),
    ("log10", False, lambda m, F, T, a, r: m.log10(T(a["pos"]))),
    ("square", False, lambda m, F, T, a, r: m.square(T(a["x"]))),
    ("pow", False, lambda m, F, T, a, r: m.pow(T(a["pos"]), 1.5)),
    ("sum", False, lambda m, F, T, a, r: m.sum(T(a["x"]), axis=1)),
    ("mean", False, lambda m, F, T, a, r: m.mean(T(a["x"]))),
    ("norm", False, lambda m, F, T, a, r: m.linalg.norm(T(a["x"]))),
    ("softmax", False, lambda m, F, T, a, r: F.softmax(T(a["x"]))),
    ("log_softmax", False, lambda m, F, T, a, r: F.log_softmax(T(a["x"]))),
    ("cross_entropy", False, lambda m, F, T, a, r: F.cross_entropy(
        T(a["x"]), r(a["labels"]))),
    ("layer_norm", False, lambda m, F, T, a, r: F.layer_norm(
        T(a["x"]), 4, T(a["w4"]), T(a["b3"][:1].repeat(4)))),
    ("batch_norm_train", False,
     lambda m, F, T, a, r: _bn(F, T, False, True)(a, r)),
    ("batch_norm_infer", False,
     lambda m, F, T, a, r: _bn(F, T, False, False)(a, r)),
    ("fused_bn_act_train", False,
     lambda m, F, T, a, r: _bn(F, T, True, True)(a, r)),
    ("fused_bn_act_infer", False,
     lambda m, F, T, a, r: _bn(F, T, True, False)(a, r)),
]


def _run_both(call, in_dtype, amp_dtype, off=False, **kw):
    """``call`` in both packages under ``auto_cast(dtype=amp_dtype,
    **kw)``, or outside any (``off``)."""
    a = _arrays()
    jT = lambda v: to_tensor(v).astype(in_dtype)  # noqa: E731
    tT = lambda v: torch.from_numpy(v.copy()).to(  # noqa: E731
        getattr(torch, in_dtype))
    jr = lambda v: to_tensor(v.astype(np.int32) if v.dtype == np.int64  # noqa
                             else v)
    tr = lambda v: torch.from_numpy(v.copy())  # noqa: E731
    for m in (jp, tp):
        with contextlib.nullcontext() if off else \
                m.amp.auto_cast(dtype=amp_dtype, **kw):
            if m is jp:
                want = call(jp, jF, jT, a, jr)
            else:
                got = call(tp, tF, tT, a, tr)
    return got, want


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name,white,call", OPS, ids=[o[0] for o in OPS])
def test_listed_ops_cast_like_the_reference(name, white, call, amp_dtype):
    """A white-listed op on float32 inputs runs in the AMP dtype, a
    black-listed one on AMP-dtype inputs in float32: the output dtype is
    the JAX package's, the values within the stated tolerance."""
    assert name in (tp.amp.WHITE_LIST if white else tp.amp.BLACK_LIST)
    in_dtype = "float32" if white else amp_dtype
    got, want = _run_both(call, in_dtype, amp_dtype)
    assert _dtype(got) == _dtype(want) == \
        (amp_dtype if white else "float32")
    if white:
        _close_lowp(got, want, amp_dtype, name)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


@pytest.mark.parametrize("name,white,call", OPS, ids=[o[0] for o in OPS])
def test_listed_ops_under_o0_and_off_stay_in_their_inputs_dtype(
        name, white, call):
    """``level="O0"`` and ``enable=False`` cast nothing, in both
    packages: the output dtype is the op's own without ``auto_cast``."""
    in_dtype = "bfloat16" if not white else "float32"
    own = _run_both(call, in_dtype, "bfloat16", off=True)
    for kw in (dict(level="O0"), dict(enable=False)):
        got, want = _run_both(call, in_dtype, "bfloat16", **kw)
        assert (_dtype(got), _dtype(want)) == tuple(map(_dtype, own))


@pytest.mark.parametrize("white", [True, False])
def test_float64_is_cast_by_the_white_list_and_kept_by_the_black(white):
    """float64 inputs go to the AMP dtype on the white list and stay
    float64 on the black list (the JAX package, without x64, has no
    float64 to compare with)."""
    x = torch.ones(2, 2, dtype=torch.float64)
    with tp.amp.auto_cast():
        y = tp.matmul(x, x) if white else tp.exp(x)
    assert y.dtype == (torch.bfloat16 if white else torch.float64)


# -- the narrow BERT classifier ---------------------------------------------

def _bert(fresh):
    jp.seed(0)
    jclf = jp.text.models.BertForSequenceClassification(
        jp.text.models.BertModel(**CFG), num_classes=2, dropout=0.0)
    tclf = tp.text.models.BertForSequenceClassification(
        tp.text.models.BertModel(device="cpu", **CFG), num_classes=2,
        dropout=0.0)
    tclf.load_state_dict(state_from_jax(_state(jclf), tclf))
    rng = np.random.default_rng(3)
    ids = rng.integers(1, CFG["vocab_size"], (B, S))
    for row, n in enumerate((S, 11, 6, 14)):    # ragged padding
        ids[row, n:] = 0
    labels = ids[:, 1] % 2
    return jclf, tclf, ids, labels


def _jax_inputs(ids, labels):
    return to_tensor(ids.astype(np.int32)), to_tensor(labels.astype(np.int32))


def _port_inputs(ids, labels):
    return (tp.to_tensor(ids.astype(np.int64), place="cpu"),
            tp.to_tensor(labels.astype(np.int64), place="cpu"))


def _traces(monkeypatch, jclf, tclf, ids, labels, amp_dtype):
    """The ``(name, output dtype)`` of every listed op of one forward and
    loss in each package, and the two losses."""
    from paddle1_tpu.autograd import engine
    listed = tp.amp.WHITE_LIST | tp.amp.BLACK_LIST
    jtrace, ttrace = [], []
    j_apply, t_run = engine._apply_impl, tp.amp._run

    def j_rec(name, *args, **kw):
        out = j_apply(name, *args, **kw)
        if name in listed:
            first = out[0] if isinstance(out, (tuple, list)) else out
            jtrace.append((name, _dtype(first)))
        return out

    def t_rec(name, *args, **kw):
        out = t_run(name, *args, **kw)
        if name in listed:
            first = out[0] if isinstance(out, (tuple, list)) else out
            ttrace.append((name, _dtype(first)))
        return out
    monkeypatch.setattr(engine, "_apply_impl", j_rec)
    monkeypatch.setattr(tp.amp, "_run", t_rec)
    jx, jy = _jax_inputs(ids, labels)
    tx, ty = _port_inputs(ids, labels)
    with jp.amp.auto_cast(dtype=amp_dtype):
        jloss = jF.cross_entropy(jclf(jx), jy)
    with tp.amp.auto_cast(dtype=amp_dtype):
        tloss = tF.cross_entropy(tclf(tx), ty)
    return jtrace, ttrace, jloss, tloss


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_bert_forward_casts_where_the_reference_casts(fresh_names,
                                                      monkeypatch,
                                                      amp_dtype):
    """The listed ops of the forward and the loss, in order, with their
    output dtypes, are the JAX package's; the loss is float32 and within
    the stated tolerance of the JAX package's."""
    jclf, tclf, ids, labels = _bert(fresh_names)
    jtrace, ttrace, jloss, tloss = _traces(monkeypatch, jclf, tclf, ids,
                                           labels, amp_dtype)
    assert ttrace == jtrace
    names = [n for n, _ in ttrace]
    assert names.count("linear") == 6 * CFG["num_hidden_layers"] + 2
    assert names.count("layer_norm") == 2 * CFG["num_hidden_layers"] + 1
    assert names[-1] == "cross_entropy" and _dtype(tloss) == "float32"
    _close_lowp(tloss, jloss, amp_dtype, "loss")


def _mlp(seed=7):
    """A Linear-GELU-LayerNorm-Linear stack (f32 parameters) and a batch."""
    with tp.utils.unique_name.guard():
        g = torch.Generator().manual_seed(seed)
        net = tp.nn.Sequential(
            tp.nn.Linear(6, 8, generator=g, device="cpu"), tp.nn.GELU()
            if hasattr(tp.nn, "GELU") else tp.nn.ReLU(),
            tp.nn.LayerNorm(8, device="cpu"),
            tp.nn.Linear(8, 3, generator=g, device="cpu"))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 5))
    return net, x, y


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_gradients_are_the_explicit_cast_computation(amp_dtype):
    """Under ``auto_cast`` the gradients equal, bit for bit, those of the
    same computation written with explicit casts in torch: each white
    op's inputs cast to the AMP dtype, each black op's to float32, the
    casts differentiated by autograd; every gradient is float32."""
    dt = getattr(torch, amp_dtype)
    net, x, y = _mlp()
    with tp.amp.auto_cast(dtype=amp_dtype):
        tF.cross_entropy(net(x), y).backward()
    got = [p.grad.clone() for p in net.parameters()]
    assert all(g.dtype == torch.float32 for g in got)
    ps = [p.detach().clone().requires_grad_() for p in net.parameters()]
    w1, b1, g, b, w2, b2 = ps
    h = net[1](torch.matmul(x.to(dt), w1.to(dt)) + b1.to(dt))
    h = tF.layer_norm(h.float(), 8, g, b)
    logits = torch.matmul(h.to(dt), w2.to(dt)) + b2.to(dt)
    tF.cross_entropy(logits.float(), y).backward()
    for p, want in zip(got, ps):
        torch.testing.assert_close(p, want.grad, rtol=0, atol=0)


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_gradients_against_the_references_where_it_runs(fresh_names,
                                                        amp_dtype):
    """A ``Linear`` on data, its output cast to float32 before the loss
    (``tests/test_training_e2e.py``'s pattern, where the JAX package's
    backward runs): the loss and the gradients are within the stated
    tolerance of the JAX package's, whose gradients of the float32
    parameters come back in the AMP dtype and are compared after a cast
    to float32; the port's are float32."""
    jp.seed(2)
    jl = jp.nn.Linear(32, 4)
    tl = tp.nn.Linear(32, 4, device="cpu")
    tl.load_state_dict(state_from_jax(_state(jl), tl))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    y = rng.integers(0, 4, 8)
    with jp.amp.auto_cast(dtype=amp_dtype):
        jloss = jF.cross_entropy(jl(to_tensor(x)).astype("float32"),
                                 to_tensor(y.astype(np.int32)))
    jloss.backward()
    with tp.amp.auto_cast(dtype=amp_dtype):
        tloss = tF.cross_entropy(tl(tp.to_tensor(x, place="cpu"))
                                 .astype("float32"), torch.from_numpy(y))
    tloss.backward()
    _close_lowp(tloss, jloss, amp_dtype, "loss")
    for jpar, tpar in ((jl.weight, tl.weight), (jl.bias, tl.bias)):
        assert _dtype(jpar.grad) == amp_dtype
        assert tpar.grad.dtype == torch.float32
        _close_lowp(tpar.grad, jpar.grad, amp_dtype, tpar.name)


# -- the departures from the JAX package, by design ---------------------------

def _linear_pair(fresh):
    jp.seed(1)
    jl = jp.nn.Linear(4, 4)
    tl = tp.nn.Linear(4, 4, device="cpu")
    tl.load_state_dict(state_from_jax(_state(jl), tl))
    x = np.random.default_rng(5).standard_normal((2, 4)).astype(np.float32)
    return jl, tl, x


BLACK_AFTER_WHITE = [
    ("mean", lambda m, F, y: y.mean()),
    ("softmax", lambda m, F, y: F.softmax(y).sum()),
    ("cross_entropy", lambda m, F, y: F.cross_entropy(
        y, (to_tensor if m is jp else torch.tensor)([0, 1]))),
    ("layer_norm", lambda m, F, y: F.layer_norm(y, 4, None, None).sum()),
]


@pytest.mark.parametrize("name,loss", BLACK_AFTER_WHITE,
                         ids=[c[0] for c in BLACK_AFTER_WHITE])
def test_departure_backward_through_a_black_listed_op_runs(fresh_names, name,
                                                            loss):
    """A white-listed ``Linear`` then a black-listed op: the JAX package's
    backward raises (its cast sits outside the recorded VJP); the port's
    runs, the cast being a differentiable op, and the parameters'
    gradients are float32 and equal those of the same ops with the casts
    written out."""
    jl, tl, x = _linear_pair(fresh_names)
    with jp.amp.auto_cast():
        jloss = loss(jp, jF, jl(to_tensor(x)))
    with pytest.raises(ValueError, match="bfloat16"):
        jloss.backward()
    with tp.amp.auto_cast():
        tloss = loss(tp, tF, tl(torch.from_numpy(x)))
    tloss.backward()
    w = tl.weight.detach().clone().requires_grad_()
    b = tl.bias.detach().clone().requires_grad_()
    y = torch.matmul(torch.from_numpy(x).bfloat16(), w.bfloat16()) + \
        b.bfloat16()
    loss(tp, tF, y.float()).backward()
    for p, want in ((tl.weight, w), (tl.bias, b)):
        assert p.grad.dtype == torch.float32
        torch.testing.assert_close(p.grad, want.grad, rtol=0, atol=0)


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_departure_bert_backward_runs_with_float32_gradients(fresh_names,
                                                            amp_dtype):
    """The narrow BERT classifier's backward under ``auto_cast``: the JAX
    package's raises even with the logits cast to float32 first (a
    white-listed ``Linear`` reads a float32 activation that needs a
    gradient, and its cast sits outside the recorded VJP); the port's
    runs, every gradient float32 and finite, the loss within the stated
    tolerance of the same model's float32 loss (the AMP dtype's rounding
    through two layers: 8 steps)."""
    jclf, tclf, ids, labels = _bert(fresh_names)
    jx, jy = _jax_inputs(ids, labels)
    tx, ty = _port_inputs(ids, labels)
    with jp.amp.auto_cast(dtype=amp_dtype):
        jloss = jF.cross_entropy(jclf(jx).astype("float32"), jy)
    with pytest.raises(ValueError, match=amp_dtype):
        jloss.backward()
    f32 = float(tF.cross_entropy(tclf(tx), ty))
    with tp.amp.auto_cast(dtype=amp_dtype):
        tloss = tF.cross_entropy(tclf(tx).astype("float32"), ty)
    tloss.backward()
    assert abs(float(tloss) - f32) <= 8 * UNIT[amp_dtype] * abs(f32)
    for p in tclf.parameters():
        assert p.grad.dtype == torch.float32, p.name
        assert bool(torch.isfinite(p.grad).all()), p.name


def test_departure_float32_parameter_gradient_is_float32(fresh_names):
    """Where the JAX package's backward runs (``astype("float32")`` before
    the loss), its float32 weight's gradient comes back bfloat16; the
    port's is float32, with the same value up to bf16's rounding."""
    jl, tl, x = _linear_pair(fresh_names)
    with jp.amp.auto_cast():
        jl(to_tensor(x)).astype("float32").mean().backward()
    with tp.amp.auto_cast():
        tl(tp.to_tensor(x, place="cpu")).astype("float32").mean().backward()
    assert _dtype(jl.weight.grad) == "bfloat16"
    assert tl.weight.grad.dtype == torch.float32
    _close_lowp(tl.weight.grad, jl.weight.grad, "bfloat16")


# -- GradScaler ---------------------------------------------------------------

ACTIONS = ["step", "step_update", "unscale_step", "minimize", "record",
           "unscale_update"]


def _scaler_run(m, layer, opt, scaler, plan, x):
    """Apply ``plan`` (``(action, finite)`` pairs) and record the state
    after each: scale, ``state_dict``, ``last_step_skipped``, weights."""
    F32 = (lambda v: to_tensor(v)) if m is jp else torch.tensor  # noqa
    seen = []
    for action, finite in plan:
        if action == "record":
            scaler.record_step(not finite)
        else:
            c = 1.0 if finite else float("inf")
            xt = to_tensor(x) if m is jp else torch.from_numpy(x)
            loss = m.sum(layer(xt)) * F32(np.float32(c))
            scaled = scaler.scale(loss)
            scaled.backward()
            if action == "step":
                scaler.step(opt)
            elif action == "step_update":
                scaler.step(opt)
                scaler.update()
            elif action == "unscale_step":
                scaler.unscale_(opt)
                scaler.step(opt)
                scaler.update()
            elif action == "minimize":
                scaler.minimize(opt, scaled)
            else:
                scaler.unscale_(opt)
                scaler.update()
            opt.clear_grad()
        w = layer.weight.numpy() if m is jp else \
            layer.weight.detach().numpy()
        seen.append((scaler.get_loss_scaling(), scaler.state_dict(),
                     scaler.last_step_skipped(), np.array(w)))
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grad_scaler_state_machine_is_the_references(fresh_names, seed):
    """Seeded sequences of finite and non-finite steps through every
    route: after each, the scale, ``state_dict``, ``last_step_skipped``
    and the weights equal the JAX package's (a skipped step leaves the
    weights as they were)."""
    rng = np.random.default_rng(seed)
    plan = [(ACTIONS[rng.integers(len(ACTIONS))], bool(rng.random() < 0.6))
            for _ in range(24)]
    jl, tl, x = _linear_pair(fresh_names)
    runs = []
    for m, layer in ((jp, jl), (tp, tl)):
        opt = m.optimizer.Momentum(0.01, 0.9, parameters=layer.parameters())
        scaler = m.amp.GradScaler(init_loss_scaling=2.0 ** 4,
                                  incr_every_n_steps=3,
                                  decr_every_n_nan_or_inf=2)
        runs.append(_scaler_run(m, layer, opt, scaler, plan, x))
    for i, (want, got) in enumerate(zip(*runs)):
        assert got[:3] == want[:3], (i, plan[:i + 1])
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-7)


def test_grad_scaler_unscale_twice_raises_and_state_round_trips(
        fresh_names):
    jl, tl, x = _linear_pair(fresh_names)
    for m, layer, err in ((jp, jl, jp.core.errors.InvalidArgumentError),
                          (tp, tl, InvalidArgumentError)):
        opt = m.optimizer.Adam(0.01, parameters=layer.parameters())
        scaler = m.amp.GradScaler(init_loss_scaling=8.0)
        xt = to_tensor(x) if m is jp else torch.from_numpy(x)
        scaler.scale(m.sum(layer(xt))).backward()
        scaler.unscale_(opt)
        with pytest.raises(err):
            scaler.unscale_(opt)
        scaler.update()
        scaler.unscale_(opt)    # update() ended the iteration
        other = m.amp.GradScaler()
        other.load_state_dict(scaler.state_dict())
        assert other.get_loss_scaling() == scaler.get_loss_scaling()
    off = tp.amp.GradScaler(enable=False)
    t = torch.ones(2)
    assert off.scale(t) is t and not off.is_enable()


def test_grad_scaler_unscales_every_dtype_group_once():
    """Gradients of three dtypes are divided by the scale once each (in
    float32, stored in their dtype) and one non-finite gradient among
    them flags the step."""
    ps = [torch.nn.Parameter(torch.ones(3, dtype=dt))
          for dt in (torch.float32, torch.bfloat16, torch.float16)]
    opt = tp.optimizer.AdamW(0.01, parameters=ps)
    scaler = tp.amp.GradScaler(init_loss_scaling=4.0)
    for p in ps:
        p.grad = torch.full((3,), 8.0, dtype=p.dtype)
    scaler.unscale_(opt)
    assert not scaler._found_inf
    for p in ps:
        assert p.grad.dtype == p.dtype and torch.equal(
            p.grad, torch.full((3,), 2.0, dtype=p.dtype))
    scaler.update()
    ps[1].grad[1] = float("nan")
    scaler.unscale_(opt)
    assert scaler._found_inf


# -- decorate, nesting, threads, O0 and the custom lists ----------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_casts_at_o2_and_returns_the_shapes_given(fresh_names,
                                                            level, dtype):
    for m, kw in ((jp, {}), (tp, dict(device="cpu"))):
        a, b = m.nn.Linear(2, 2, **kw), m.nn.Linear(2, 2, **kw)
        opt = m.optimizer.AdamW(0.01, parameters=a.parameters())
        assert m.amp.decorate(a, level=level, dtype=dtype) is a
        assert m.amp.decorate([a, b], level=level, dtype=dtype) == [a, b]
        got = m.amp.decorate(a, opt, level=level, dtype=dtype)
        assert got[0] is a and got[1] is opt
        want = dtype if level == "O2" else "float32"
        assert {_dtype(p) for p in list(a.parameters()) +
                list(b.parameters())} == {want}


def _matmul_dtype(m):
    T = (lambda v: to_tensor(v)) if m is jp else torch.from_numpy  # noqa
    x = T(np.ones((2, 2), np.float32))
    return _dtype(m.matmul(x, x)), _dtype(m.exp(m.matmul(x, x)))


@pytest.mark.parametrize("m", [jp, tp], ids=["jax", "port"])
def test_nesting_o0_custom_lists_and_a_bad_level(m):
    """Each package alone, the same answers: nested contexts restore the
    outer state on exit, ``O0`` turns the casts off, a custom white name
    moves an op into low precision and a custom black name out of it, a
    bad level raises."""
    got = []
    with m.amp.auto_cast():
        got.append(_matmul_dtype(m))
        with m.amp.auto_cast(dtype="float16"):
            got.append(_matmul_dtype(m))
            with m.amp.auto_cast(level="O0"):
                got.append(_matmul_dtype(m))
            got.append(_matmul_dtype(m))
        with m.amp.auto_cast(custom_white_list=["exp"],
                             custom_black_list=["matmul"]):
            got.append(_matmul_dtype(m))
        got.append(_matmul_dtype(m))
    got.append(_matmul_dtype(m))
    assert m.amp.amp_state() is None
    assert got == [("bfloat16", "float32"), ("float16", "float32"),
                   ("float32", "float32"), ("float16", "float32"),
                   ("float32", "bfloat16"), ("bfloat16", "float32"),
                   ("float32", "float32")]
    with pytest.raises(Exception, match="O0/O1/O2"):
        with m.amp.auto_cast(level="O3"):
            pass


def test_the_state_is_per_thread():
    """Another thread sees no AMP state while this one is inside
    ``auto_cast``, and its own context does not leak here."""
    seen = {}

    def other():
        seen["outside"] = tp.amp.amp_state()
        with tp.amp.auto_cast(dtype="float16"):
            seen["inside"] = _matmul_dtype(tp)

    with tp.amp.auto_cast():
        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert _matmul_dtype(tp) == ("bfloat16", "float32")
    assert seen == {"outside": None, "inside": ("float16", "float32")}


def test_amp_off_adds_no_dispatched_call():
    """With AMP off a named op reads one thread-local and calls the op:
    the facade's shared-name methods are not called, and the result is
    the op's own."""
    x = tp.to_tensor(np.ones((2, 2), np.float32), place="cpu")
    assert tp.amp.amp_state() is None
    y = tp.matmul(x, x)
    assert isinstance(y, tp.Tensor) and y.dtype == torch.float32
