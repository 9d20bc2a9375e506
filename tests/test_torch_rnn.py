"""``nn/layer_rnn.py`` against the JAX package on the CPU: every cell and
net built in both packages, the JAX package's seeded weights carried
across by ``convert.state_from_jax``, called on the same seeded numpy
inputs. Values within 1e-5; the gradients of a weighted sum of every
output (the sequence and the final states) with respect to the input, the
given initial states and every parameter within 1e-4 (f32).

Covered: the three cells with given and default states (``SimpleRNNCell``
with ``relu`` too); the nets at one and two layers, forward and
bidirectional, batch-major and ``time_major``, with given and default
initial states, at dropout 0 and at dropout > 0 in eval mode;
``sequence_length`` taken and not read by ``RNN``, ``BiRNN`` and the nets
in both packages; ``RNN(cell)`` equal to the one-layer net over the same
weights; ``BiRNN``; the parameter names; the reference's positional
signatures; dropout between the layers in training only; and
``rnn_layer_cases`` of ``tests/test_torch_nn_cases.py`` (phase 28's on the
card) through both packages.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax

from test_torch_nn_cases import rnn_layer_cases
from test_torch_op_cases import ids

B, T, I, H = 3, 5, 4, 6
TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _np(t):
    return t.detach().cpu().numpy() if type(t) is torch.Tensor else \
        np.asarray(t.numpy())


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _pair(make, seed=0):
    """``make(nn)`` in both packages, the JAX package's weights in the
    port's layer."""
    jp.seed(seed)
    jl = make(jp.nn)
    with tp.utils.unique_name.guard():
        tl = make(tp.nn)
    tl.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jl.functional_state().items()}, tl))
    return jl, tl


def _data(shape, seed, pkg, grad=True):
    t = pkg.to_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))
    if grad:
        t.stop_gradient = False
    return t


def _states(pkg, shapes, seed):
    """Initial states of ``shapes`` (a shape, or a tuple of such, as an
    LSTM's ``(h, c)``), needing gradients."""
    if isinstance(shapes[0], tuple):
        return tuple(_states(pkg, s, seed + 10 * i)
                     for i, s in enumerate(shapes))
    return _data(shapes, seed, pkg)


def _run(jl, tl, x_shape, states=None, call=None, train=False):
    """Both layers on the same input (and initial states): the outputs'
    leaves and the gradients of the input, the states and every
    parameter."""
    call = call or (lambda layer, x, s: layer(x, s))
    res = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        layer.train() if train else layer.eval()
        x = _data(x_shape, 7, pkg)
        s = None if states is None else _states(pkg, states, 11)
        out = _leaves(call(layer, x, s))
        loss = None
        for k, o in enumerate(out):
            w = np.random.default_rng(20 + k).standard_normal(
                tuple(_np(o).shape)).astype(np.float32)
            term = (o * pkg.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = {"x": _np(x.grad)}
        for i, leaf in enumerate(_leaves(s) if s is not None else []):
            grads[f"state{i}"] = _np(leaf.grad)
        for n, p in layer.named_parameters():
            grads[n] = _np(p.grad)
        res.append(([_np(o) for o in out], grads))
    (jo, jg), (to, tg) = res
    assert len(jo) == len(to)
    for k, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=k)
    assert sorted(jg) == sorted(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)
    return jo, to


CELLS = [
    ("SimpleRNNCell", (I, H), (B, H)),
    ("SimpleRNNCell-relu", (I, H, "relu"), (B, H)),
    ("LSTMCell", (I, H), ((B, H), (B, H))),
    ("GRUCell", (I, H), (B, H)),
]


@pytest.mark.parametrize("given", [True, False], ids=["states", "default"])
@pytest.mark.parametrize("name,ctor,states", CELLS,
                         ids=[c[0] for c in CELLS])
def test_cell_matches_the_reference(name, ctor, states, given):
    cls = name.split("-")[0]
    jl, tl = _pair(lambda nn: getattr(nn, cls)(*ctor))
    _run(jl, tl, (B, I), states if given else None)


@pytest.mark.parametrize("name,states", [
    ("SimpleRNNCell", (2, B, H)), ("LSTMCell", ((2, B, H), (2, B, H))),
    ("GRUCell", (2, B, H))])
def test_cell_takes_leading_dimensions_as_the_reference(name, states):
    """A cell on ``[2, B, in]`` (the ``_VF`` cells take 2-D inputs: the
    port folds the leading dimensions)."""
    jl, tl = _pair(lambda nn: getattr(nn, name)(I, H))
    _run(jl, tl, (2, B, I), states)


def test_cells_return_the_reference_s_state_structure():
    x = np.ones((2, I), np.float32)
    for cls in ("SimpleRNNCell", "LSTMCell", "GRUCell"):
        with tp.utils.unique_name.guard():
            cell = getattr(tp.nn, cls)(I, H)
        out, st = cell(tp.to_tensor(x))
        if cls == "LSTMCell":
            h, c = st
            assert torch.equal(out, h) and tuple(c.shape) == (2, H)
        else:
            assert torch.equal(out, st)
        init = cell.get_initial_states(tp.to_tensor(x), init_value=0.5)
        assert tuple(init.shape) == (2, H) and float(init.max()) == 0.5
        assert cell.state_shape == (((H,), (H,)) if cls == "LSTMCell"
                                    else (H,))


# (class, layers, direction, time_major, initial states given, kwargs)
NETS = [
    ("LSTM", 1, "forward", False, False, {}),
    ("LSTM", 2, "bidirect", False, True, {}),
    ("LSTM", 2, "forward", True, True, {}),
    ("LSTM", 1, "bidirectional", True, False, {}),
    ("GRU", 1, "forward", False, True, {}),
    ("GRU", 2, "bidirect", False, False, {}),
    ("GRU", 2, "forward", True, False, {}),
    ("SimpleRNN", 1, "forward", False, True, {}),
    ("SimpleRNN", 2, "bidirect", True, True, {}),
    ("SimpleRNN", 2, "forward", False, False, {"activation": "relu"}),
    ("LSTM", 2, "bidirect", False, False, {"dropout": 0.5}),
    ("GRU", 2, "forward", False, True, {"dropout": 0.3}),
]


def _net_id(n):
    cls, nl, d, tm, given, kw = n
    return "-".join([cls, f"{nl}l", d, "tm" if tm else "bm",
                     "states" if given else "default"] +
                    [f"{k}{v}" for k, v in kw.items()])


def _state_shapes(cls, nl, nd):
    s = (nl * nd, B, H)
    return (s, s) if cls == "LSTM" else s


@pytest.mark.parametrize("net", NETS, ids=[_net_id(n) for n in NETS])
def test_net_matches_the_reference(net):
    """Dropout > 0 is held in eval mode, where both packages skip it."""
    cls, nl, direction, tm, given, kw = net
    jl, tl = _pair(lambda nn: getattr(nn, cls)(
        I, H, nl, direction, tm, **kw))
    nd = 2 if direction != "forward" else 1
    x_shape = (T, B, I) if tm else (B, T, I)
    jo, _ = _run(jl, tl, x_shape,
                 _state_shapes(cls, nl, nd) if given else None)
    assert jo[0].shape == ((T, B, nd * H) if tm else (B, T, nd * H))
    assert jo[1].shape == (nl * nd, B, H)


def test_net_parameter_names_are_the_reference_s():
    jl, tl = _pair(lambda nn: nn.GRU(I, H, 2, "bidirect"))
    names = [n for n, _ in tl.named_parameters()]
    assert names == [n for n, _ in jl.named_parameters()]
    assert names[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0"]
    assert names[4] == "weight_ih_l0_reverse"
    assert tuple(tl.weight_ih_l1.shape) == (3 * H, 2 * H)
    bound = 1 / np.sqrt(H)
    assert all(float(p.abs().max()) <= bound for p in tl.parameters())


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_sequence_length_is_ignored_by_the_nets_as_in_the_reference(cls):
    """Both packages take ``sequence_length`` and never read it: the
    outputs and final states with lengths equal those without, in each
    package (Paddle's reference would mask past each length)."""
    jl, tl = _pair(lambda nn: getattr(nn, cls)(I, H, 2, "bidirect"))
    lengths = np.array([5, 2, 3], np.int64)
    for pkg, layer in ((jp, jl), (tp, tl)):
        x = _data((B, T, I), 3, pkg, grad=False)
        plain = _leaves(layer(x))
        masked = _leaves(layer(x, None, pkg.to_tensor(lengths)))
        for a, b in zip(plain, masked):
            np.testing.assert_array_equal(_np(a), _np(b))
    _run(jl, tl, (B, T, I), call=lambda layer, x, s: layer(
        x, None, (jp if isinstance(layer, jp.nn.Layer) else tp).to_tensor(
            lengths)))


def test_sequence_length_is_ignored_by_rnn_and_birnn():
    def make(nn):
        return nn.BiRNN(nn.GRUCell(I, H), nn.GRUCell(I, H))
    jl, tl = _pair(make)
    lengths = np.array([5, 2, 3], np.int64)
    for pkg, layer in ((jp, jl), (tp, tl)):
        x = _data((B, T, I), 4, pkg, grad=False)
        for rnn in (layer, layer.rnn_fw):
            a, b = _leaves(rnn(x)), _leaves(rnn(x, None,
                                                pkg.to_tensor(lengths)))
            for u, v in zip(a, b):
                np.testing.assert_array_equal(_np(u), _np(v))


@pytest.mark.parametrize("reverse,tm", [(False, False), (True, False),
                                        (False, True)],
                         ids=["forward", "reverse", "time-major"])
@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_rnn_wrapper_matches_the_reference(cell, reverse, tm):
    jl, tl = _pair(lambda nn: nn.RNN(getattr(nn, cell)(I, H), reverse, tm))
    states = ((B, H), (B, H)) if cell == "LSTMCell" else (B, H)
    _run(jl, tl, (T, B, I) if tm else (B, T, I), states)


def test_birnn_matches_the_reference():
    def make(nn):
        return nn.BiRNN(nn.LSTMCell(I, H), nn.LSTMCell(I, H))
    jl, tl = _pair(make)
    jo, _ = _run(jl, tl, (B, T, I), (((B, H), (B, H)), ((B, H), (B, H))),
                 call=lambda layer, x, s: layer(x, s))
    assert jo[0].shape == (B, T, 2 * H)


@pytest.mark.parametrize("cls,cell", [("LSTM", "LSTMCell"),
                                      ("GRU", "GRUCell"),
                                      ("SimpleRNN", "SimpleRNNCell")])
def test_rnn_of_a_cell_equals_the_one_layer_net(cls, cell):
    """The port's net (one ``_VF`` call) against its own ``RNN(cell)`` (one
    ``_VF`` cell call a step) over the same weights."""
    with tp.utils.unique_name.guard():
        net = getattr(tp.nn, cls)(I, H)
        rnn = tp.nn.RNN(getattr(tp.nn, cell)(I, H))
    rnn.cell.load_state_dict({k[:-len("_l0")]: v for k, v in
                              net.state_dict().items()})
    x = _data((B, T, I), 5, tp)
    x2 = x.detach().clone()
    x2.stop_gradient = False
    (no, ns), (ro, rs) = net(x), rnn(x2)
    np.testing.assert_allclose(_np(ro), _np(no), rtol=TOL, atol=TOL)
    for a, b in zip(_leaves(rs), _leaves(ns)):
        np.testing.assert_allclose(_np(a), _np(b)[0], rtol=TOL, atol=TOL)
    w = tp.to_tensor(np.random.default_rng(6).standard_normal(
        (B, T, H)).astype(np.float32))
    (no * w).sum().backward()
    (ro * w).sum().backward()
    np.testing.assert_allclose(_np(x2.grad), _np(x.grad), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    for k, p in net.named_parameters():
        np.testing.assert_allclose(
            _np(getattr(rnn.cell, k[:-len("_l0")]).grad), _np(p.grad),
            rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_dropout_goes_between_layers_in_training_only():
    with tp.utils.unique_name.guard():
        one = tp.nn.LSTM(I, H, 1, dropout=0.9)
        two = tp.nn.LSTM(I, H, 2, dropout=0.9)
    x = _data((B, T, I), 8, tp, grad=False)
    tp.seed(3)
    a = _np(one(x)[0])
    tp.seed(4)
    b = _np(one(x)[0])
    np.testing.assert_array_equal(a, b)     # one layer: no dropout
    tp.seed(3)
    c = _np(two(x)[0])
    tp.seed(4)
    d = _np(two(x)[0])
    assert not np.array_equal(c, d)         # between the two layers
    tp.seed(3)
    np.testing.assert_array_equal(_np(two(x)[0]), c)
    two.eval()
    e, f = _np(two(x)[0]), _np(two(x)[0])
    np.testing.assert_array_equal(e, f)


def test_bad_direction_raises():
    from paddle1_tpu_torch.core.errors import InvalidArgumentError
    with pytest.raises(InvalidArgumentError):
        tp.nn.LSTM(I, H, direction="backward")


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind != p.KEYWORD_ONLY]


def test_every_rnn_name_is_ported_with_the_reference_signature():
    jm = importlib.import_module("paddle1_tpu.nn.layer_rnn")
    tm = importlib.import_module("paddle1_tpu_torch.nn.layer_rnn")
    assert set(jm.__all__) <= set(tm.__all__)
    for name in jm.__all__:
        assert getattr(tp.nn, name) is getattr(tm, name)
        jc, tc = getattr(jm, name), getattr(tm, name)
        assert _positional(tc.__init__) == _positional(jc.__init__), name
        if "forward" in vars(jc):
            assert _positional(tc.forward) == _positional(jc.forward), name
    assert _positional(tm.RNNCellBase.get_initial_states) == \
        _positional(jm.RNNCellBase.get_initial_states)


CASES = rnn_layer_cases()


def _case_args(pkg, case):
    def t(v, grad):
        if isinstance(v, list):
            return [t(e, grad) for e in v]
        if not isinstance(v, np.ndarray):
            return v
        x = pkg.to_tensor(v)
        if grad:
            x.stop_gradient = False
        return x
    return [t(a, i in case.grad) for i, a in enumerate(case.args)]


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_rnn_layer_case_matches_the_reference(case):
    """``tests/test_torch_nn_cases.py``'s recurrent cases (which
    ``chip_smoke.py`` phase 28 runs on the card) through both packages:
    every output leaf, the gradients of the listed inputs and of every
    parameter, each case's tolerance."""
    def build(nn):
        return getattr(nn, case.op)(*[a(nn) if callable(a) else a
                                      for a in case.ctor], **case.ctor_kw)
    jl, tl = _pair(build)
    res = []
    for pkg, layer in ((jp, jl), (tp, tl)):
        layer.train() if case.train else layer.eval()
        args = _case_args(pkg, case)
        out = _leaves(layer(*args))
        loss = None
        for k, o in enumerate(out):
            w = np.random.default_rng(40 + k).standard_normal(
                tuple(_np(o).shape)).astype(np.float32)
            term = (o * pkg.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = {f"arg {i}": _np(args[i].grad) for i in case.grad}
        grads.update({n: _np(p.grad) for n, p in layer.named_parameters()})
        res.append(([_np(o) for o in out], grads))
    (jo, jg), (to, tg) = res
    assert [a.shape for a in jo] == [b.shape for b in to]
    for k, (a, b) in enumerate(zip(jo, to)):
        np.testing.assert_allclose(b, a, rtol=case.tol, atol=case.tol,
                                   err_msg=f"output {k}")
    assert sorted(jg) == sorted(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)


def test_every_rnn_name_but_the_abstract_base_has_a_case():
    jm = importlib.import_module("paddle1_tpu.nn.layer_rnn")
    assert set(jm.__all__) - {c.op for c in CASES} == {"RNNCellBase"}
