"""The port's ``nn.Layer`` against the JAX package's (ROADMAP Queue 1
item 2): naming, traversal order, state dicts, hooks, ``apply``,
``astype``, ``clear_gradients`` and ``create_parameter`` under every
``ParamAttr`` form, held to ``paddle1_tpu.nn.Layer`` on the same calls;
and the torch callers a Layer must keep working (``functional_call``,
``recompute``, ``load_state_dict`` of ``convert.state_from_jax``) on a
rebased BERT.

Inputs and weights come from numpy with a seed; weights cross through
``convert.state_from_jax``. Both packages' layer-name counters are reset
where names are compared. Everything is float32; each tolerance is
stated where used.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core.errors import InvalidArgumentError as JInvalid
from paddle1_tpu.core.tensor import to_tensor
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.errors import InvalidArgumentError

# one layer's products and sums in f32 in another order
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(t):
    return np.asarray(t.numpy())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.functional_state().items()}


def _carried(jlayer, tlayer):
    tlayer.load_state_dict(state_from_jax(_state(jlayer), tlayer))
    return tlayer


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


def _net_class(m):
    """The same small network written against either package: a conv, a
    batch norm, a named sublayer scope, a Sequential and a direct
    parameter."""
    kw = {} if m is jp else dict(device="cpu")

    class Head(m.nn.Layer):
        def __init__(self):
            super().__init__(name_scope="head")
            self.fc = m.nn.Linear(8, 3, **kw)
            self.scale = self.create_parameter(
                [3], default_initializer=m.nn.initializer.Constant(2.0),
                **kw)

        def forward(self, x):
            return self.fc(x) * self.scale

    class Net(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = m.nn.Conv2D(2, 4, 3, padding=1, **kw)
            self.bn = m.nn.BatchNorm2D(4, **kw)
            self.body = m.nn.Sequential(m.nn.Linear(16, 8, **kw),
                                        m.nn.ReLU())
            self.head = Head()

        def forward(self, x):
            y = self.bn(self.conv(x))
            return self.head(self.body(y.reshape([y.shape[0], 4, 16])
                                       .mean(axis=1) if m is jp else
                                       y.reshape(y.shape[0], 4, 16)
                                       .mean(1)))

    return Net


@pytest.fixture
def nets(fresh_names):
    jn = _net_class(jp)()
    tn = _carried(jn, _net_class(tp)())
    return jn, tn


def test_names_and_full_names_are_the_references(nets):
    jn, tn = nets
    assert [(n, p.name) for n, p in tn.named_parameters()] == \
        [(n, p.name) for n, p in jn.named_parameters()]
    assert [l.full_name() for l in tn.sublayers(include_self=True)] == \
        [l.full_name() for l in jn.sublayers(include_self=True)]
    assert tn.head.full_name() == "head_0" and tn.full_name() == "net_0"
    assert tn.head.scale.name == "head_0.scale"


def test_traversal_order_is_the_references(nets):
    jn, tn = nets
    for method, kw in (("named_sublayers", {}),
                       ("named_sublayers", dict(include_self=True)),
                       ("named_sublayers", dict(prefix="m")),
                       ("named_parameters", {}),
                       ("named_parameters", dict(include_sublayers=False)),
                       ("named_buffers", {})):
        assert [n for n, _ in getattr(tn, method)(**kw)] == \
            [n for n, _ in getattr(jn, method)(**kw)], (method, kw)
    assert isinstance(tn.parameters(), list) and \
        isinstance(tn.buffers(), list)
    assert len(tn.parameters()) == len(jn.parameters())
    assert len(tn.buffers()) == len(jn.buffers()) == 2
    assert len(tn.sublayers()) == len(jn.sublayers())
    assert [type(l).__name__ for l in tn.children()] == \
        [type(l).__name__ for l in jn.children()]
    # torch's own forms still work
    assert [n for n, _ in tn.named_parameters(recurse=False)] == []
    assert len(list(tn.parameters(recurse=True))) == len(tn.parameters())


def test_state_dict_keys_and_prefix_are_the_references(nets):
    jn, tn = nets
    assert list(tn.state_dict()) == list(jn.state_dict())
    assert list(tn.state_dict(structured_name_prefix="m.")) == \
        list(jn.state_dict(structured_name_prefix="m."))
    assert list(tn.head.state_dict(include_sublayers=False)) == \
        list(jn.head.state_dict(include_sublayers=False)) == ["scale"]
    # torch's recursive form
    assert list(tn.state_dict(prefix="p.", keep_vars=True)) == \
        ["p." + k for k in tn.state_dict()]


def test_set_state_dict_missing_unexpected_and_mismatch(nets):
    jn, tn = nets
    full = {k: _x(tuple(v.shape), i)
            for i, (k, v) in enumerate(_state(jn).items())}
    part = {k: v for k, v in full.items() if not k.startswith("head.")}
    part["extra.weight"] = np.zeros(3, np.float32)
    want = jn.set_state_dict({k: to_tensor(v) for k, v in part.items()})
    got = tn.set_state_dict(part)
    assert tuple(got) == tuple(want)
    assert got[1] == ["extra.weight"] and "head.scale" in got[0]
    for k, v in part.items():
        if k in full:
            np.testing.assert_array_equal(tn.state_dict()[k].numpy(), v)
    # Paddle tensors, numpy and torch tensors are all taken
    sd = tp.to_tensor(full["conv.weight"], place="cpu")
    assert tn.set_dict({"conv.weight": sd})[1] == []
    assert tn.load_dict({"conv.bias": _t(full["conv.bias"])})[1] == []
    bad = {"conv.weight": np.zeros((4, 2, 1, 1), np.float32)}
    with pytest.raises(JInvalid) as je:
        jn.set_state_dict({k: to_tensor(v) for k, v in bad.items()})
    with pytest.raises(InvalidArgumentError) as te:
        tn.set_state_dict(bad)
    assert str(te.value) == str(je.value)


def test_set_state_dict_by_parameter_name(nets):
    _, tn = nets
    w = _x((3,), 40)
    missing, unexpected = tn.set_state_dict({"head_0.scale": w},
                                            use_structured_name=False)
    assert unexpected == [] and "head_0.scale" not in missing
    np.testing.assert_array_equal(tn.head.scale.detach().numpy(), w)


def test_forward_hooks_and_their_removal(nets):
    jn, tn = nets
    x = _x((2, 2, 4, 4), 41)
    outs = []
    for net, xt in ((jn, to_tensor(x)), (tn, _t(x))):
        net.eval()
        seen = []
        pre = net.head.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2.0,))
        post = net.head.register_forward_post_hook(
            lambda layer, inputs, out: seen.append(layer.full_name()) or
            out + 1.0)
        hooked = net(xt)
        pre.remove()
        post.remove()
        plain = net(xt)
        outs.append((_np(hooked) if net is jn else hooked.detach().numpy(),
                     _np(plain) if net is jn else plain.detach().numpy(),
                     seen))
    (jh, jplain, jseen), (th, tplain, tseen) = outs
    np.testing.assert_allclose(th, jh, **TOL)
    np.testing.assert_allclose(tplain, jplain, **TOL)
    assert tseen == jseen == ["head_0"]
    assert not np.allclose(th, tplain)


def test_apply_astype_and_clear_gradients(nets):
    jn, tn = nets
    jorder, torder = [], []
    jn.apply(lambda l: jorder.append(l.full_name()))
    tn.apply(lambda l: torder.append(l.full_name()))
    assert torder == jorder
    x = _x((2, 2, 4, 4), 42)
    (jn(to_tensor(x)) ** 2).sum().backward()
    (tn(_t(x)) ** 2).sum().backward()
    assert all(p.grad is not None for p in tn.parameters())
    jn.clear_gradients()
    tn.clear_gradients()
    assert all(p.grad is None for p in tn.parameters())
    assert all(p.grad is None for p in jn.parameters())
    jn.astype("float16")
    tn.astype("float16")
    assert [str(p.dtype).split(".")[-1] for p in tn.parameters()] == \
        [str(p.dtype) for p in jn.parameters()]
    assert tn.bn._mean.dtype == torch.float16
    tn.float()
    assert all(p.dtype == torch.float32 for p in tn.parameters())
    tn.to(dtype="bfloat16")
    assert tn.conv.weight.dtype == torch.bfloat16
    tn.to("cpu", "float32", blocking=True)
    assert tn.conv.weight.dtype == torch.float32


PARAM_ATTR_FORMS = ["none", "false", "name", "initializer", "full"]


def _attr_form(m, form):
    if form == "none":
        return None
    if form == "false":
        return False
    if form == "name":
        return "my_param"
    if form == "initializer":
        return m.nn.initializer.Constant(0.9)
    return m.ParamAttr(name="full_param",
                       initializer=m.nn.initializer.Constant(0.7),
                       learning_rate=0.3,
                       regularizer=m.regularizer.L2Decay(0.2),
                       trainable=False, need_clip=False)


@pytest.mark.parametrize("form", PARAM_ATTR_FORMS)
@pytest.mark.parametrize("is_bias", [False, True])
def test_create_parameter_under_every_param_attr_form(fresh_names, form,
                                                      is_bias):
    made = []
    for m, kw in ((jp, {}), (tp, dict(device="cpu"))):
        class Holder(m.nn.Layer):
            def __init__(self):
                super().__init__()
                self.w = self.create_parameter(
                    [3, 4], attr=_attr_form(m, form), is_bias=is_bias,
                    default_initializer=None if is_bias else
                    m.nn.initializer.Constant(0.3), **kw)
        made.append(Holder().w)
    jw, tw = made
    assert isinstance(tw, tp.core.tensor.ParamBase)
    assert (tw.name, tuple(tw.shape), tw.trainable, tw.optimize_attr,
            getattr(tw.regularizer, "coeff", None), tw.need_clip) == \
        (jw.name, tuple(jw.shape), jw.trainable, jw.optimize_attr,
         getattr(jw.regularizer, "coeff", None), jw.need_clip)
    np.testing.assert_array_equal(tw.detach().numpy(), _np(jw))
    assert tw.stop_gradient == jw.stop_gradient == (form == "full")


def test_create_parameter_default_weight_is_xavier_uniform(fresh_names):
    lin = tp.nn.Linear(300, 200, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    limit = float(np.sqrt(6.0 / 500))
    w = lin.weight.detach().numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.99 * limit
    assert (lin.bias.detach().numpy() == 0).all()
    # the same seed, the same weights
    again = tp.nn.Linear(300, 200, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, lin.weight)


def test_containers_are_the_references(fresh_names):
    mods = []
    for m, kw in ((jp, {}), (tp, dict(device="cpu"))):
        seq = m.nn.Sequential(("a", m.nn.Linear(2, 3, **kw)),
                              ("b", m.nn.ReLU()))
        ll = m.nn.LayerList([m.nn.Linear(3, 3, **kw)])
        ll.append(m.nn.Linear(3, 4, **kw))
        ll.insert(0, m.nn.ReLU())
        ld = m.nn.LayerDict({"x": m.nn.Linear(4, 1, **kw)})
        pl = m.nn.ParameterList([seq[0].weight])
        mods.append((seq, ll, ld, pl))
    (js, jl, jd, jpl), (ts, tl, td, tpl) = mods
    assert [n for n, _ in ts.named_parameters()] == \
        [n for n, _ in js.named_parameters()]
    assert len(tl) == len(jl) == 3 and \
        [type(l).__name__ for l in tl] == [type(l).__name__ for l in jl]
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    assert list(td.keys()) == list(jd.keys()) == ["x"] and "x" in td
    assert len(tpl) == len(jpl) == 1 and tpl[0] is ts[0].weight
    assert isinstance(ts[0:1], tp.nn.Sequential) and len(ts[0:1]) == 1
    x = _x((5, 2), 43)
    _carried(js, ts)
    np.testing.assert_allclose(ts(_t(x)).detach().numpy(),
                               _np(js(to_tensor(x))), **TOL)


# ---------------------------------------------------------------------------
# torch's callers on a rebased BERT

CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=32, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def bert_pair():
    from paddle1_tpu.text.models import BertModel as JBert
    jp.seed(0)
    jm = JBert(**CFG)
    tm = tp.text.models.BertModel(device="cpu", **CFG)
    tm.load_state_dict(state_from_jax(_state(jm), tm))
    ids = np.random.default_rng(44).integers(1, 64, (2, 12)).astype(
        np.int64)
    ids[1, 8:] = 0
    return jm, tm, ids


def test_state_from_jax_on_a_rebased_bert(bert_pair):
    jm, tm, ids = bert_pair
    assert isinstance(tm, tp.nn.Layer) and \
        isinstance(tm.encoder.layers, tp.nn.LayerList)
    assert list(tm.state_dict()) == list(jm.state_dict())
    jenc, jpool = jm(to_tensor(ids.astype(np.int32)))
    tenc, tpool = tm(_t(ids))
    np.testing.assert_allclose(tenc.detach().numpy(), _np(jenc), **TOL)
    np.testing.assert_allclose(tpool.detach().numpy(), _np(jpool), **TOL)


def test_functional_call_on_a_rebased_bert(bert_pair):
    _, tm, ids = bert_pair
    params = {k: v.detach() * 1.5 for k, v in tm.named_parameters()}
    got = torch.func.functional_call(tm, params, (_t(ids),))[1]
    saved = {k: v.detach().clone() for k, v in tm.named_parameters()}
    with torch.no_grad():
        for k, v in tm.named_parameters():
            v.copy_(params[k])
        want = tm(_t(ids))[1]
        for k, v in tm.named_parameters():
            v.copy_(saved[k])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_recompute_on_a_rebased_bert(bert_pair):
    _, tm, ids = bert_pair
    grads = []
    for remat in (False, True):
        tm.encoder.enable_recompute = remat
        tm.train()
        tm.clear_gradients()
        enc, pooled = tm(_t(ids))
        (enc.square().mean() + pooled.sum()).backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    tm.encoder.enable_recompute = False
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_what_stays_out_raises_naming_its_roadmap_item():
    from paddle1_tpu_torch.core.errors import UnimplementedError
    w = torch.nn.Parameter(torch.zeros(2))
    # MultiHeadAttention.gen_cache (Cache/StaticCache) is ported: its
    # tests are in tests/test_torch_transformer.py
    for call in (
            lambda: tp.nn.Embedding(10, 4, sparse=True, device="cpu"),
            lambda: tp.optimizer.AdamW(parameters=[w], lazy_mode=True)):
        with pytest.raises(UnimplementedError, match="ROADMAP Queue 1 item"):
            call()


@pytest.mark.parametrize("opt_name", ["Momentum", "Adam", "AdamW"])
def test_optimizers_take_param_attr_fields_like_the_reference(fresh_names,
                                                              opt_name):
    """Per-parameter rate (0 included), regularizer, ``need_clip`` under a
    global-norm clip and ``trainable=False``, three eager steps against
    the JAX eager loop (the JAX package's Adam tolerance)."""
    models = []
    for m, kw in ((jp, {}), (tp, dict(device="cpu"))):
        net = m.nn.Sequential(
            m.nn.Linear(4, 6, m.ParamAttr(
                learning_rate=0.5, regularizer=m.regularizer.L2Decay(0.1)),
                m.ParamAttr(learning_rate=0.0), **kw),
            m.nn.Linear(6, 3, m.ParamAttr(need_clip=False),
                        m.ParamAttr(trainable=False), **kw))
        models.append(net)
    jn, tn = models
    _carried(jn, tn)
    x = _x((5, 4), 45)
    for m, net in ((jp, jn), (tp, tn)):
        opt = getattr(m.optimizer, opt_name)(
            learning_rate=0.05, parameters=net.parameters(),
            grad_clip=m.nn.ClipGradByGlobalNorm(0.1))
        for _ in range(3):
            xt = to_tensor(x) if m is jp else _t(x)
            (net(xt) ** 2).mean().backward()
            opt.step()
            opt.clear_gradients()
    for k, v in _state(jn).items():
        np.testing.assert_allclose(tn.state_dict()[k].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # a zero rate and a frozen parameter stay where they started
    np.testing.assert_array_equal(tn[0].bias.detach().numpy(),
                                  np.zeros(6, np.float32))
    np.testing.assert_array_equal(tn[1].bias.detach().numpy(),
                                  np.zeros(3, np.float32))
