"""The port's Tensor methods (``paddle1_tpu_torch/ops/patch.py``) against
``paddle1_tpu/ops/patch.py``, and the inventory of the op namespace.

* Inventory: every public attribute of the JAX ``Tensor`` exists on the
  port's, and every name of the JAX ``math_ops``/``manip_ops``/
  ``linalg_ops`` ``__all__`` exists in the port's module, taking the
  reference's positional parameters in the reference's order (port-only
  parameters keyword-only). A reference method written as a lambda is
  held to its count of parameters.
* Methods: one case per method, the same seeded numpy inputs through the
  JAX ``Tensor``'s method and the port facade's (values and dtypes;
  gradients for differentiable ones at 1e-6, reductions 1e-5), the
  in-place methods compared on their tensor after the call.
* Torch keeps its meaning: torch's functions and torch's own Python code
  on facade tensors (``torch.split(x, 3, 1)``, ``torch.gather``,
  ``torch.where``, ``torch.median``, ``F.multi_head_attention_forward``)
  give what they give on plain tensors, and torch's arguments to a shared
  method keep torch's meaning.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.ops import linalg_ops as jl
from paddle1_tpu.ops import manip_ops as jmanip
from paddle1_tpu.ops import math_ops as jmath
from paddle1_tpu_torch.ops import linalg_ops as tl
from paddle1_tpu_torch.ops import manip_ops as tmanip
from paddle1_tpu_torch.ops import math_ops as tmath
from paddle1_tpu_torch.ops.patch import in_torch_code

from test_torch_op_parity import R, assert_same, ids, run
from test_torch_op_cases import method, method_cases


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


# -- inventory ----------------------------------------------------------------

def _positional(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                          p.VAR_POSITIONAL)]


def test_every_public_attribute_of_the_reference_tensor_exists():
    t = tp.to_tensor(np.zeros((2, 3), np.float32))
    missing = [a for a in dir(jp.Tensor) if not a.startswith("_") and
               not hasattr(t, a)]
    assert missing == []


MODULES = [("math_ops", jmath, tmath), ("manip_ops", jmanip, tmanip),
           ("linalg_ops", jl, tl)]
NAMES = [(m, n) for m, jmod, _ in MODULES for n in jmod.__all__]


@pytest.mark.parametrize("module,name", NAMES,
                         ids=[f"{m}.{n}" for m, n in NAMES])
def test_namespace_name_takes_the_references_parameters(module, name):
    jmod, tmod = {m: (j, t) for m, j, t in MODULES}[module]
    assert name in tmod.__all__, f"{module}.{name} is missing"
    jf, tf = getattr(jmod, name), getattr(tmod, name)
    want, got = _positional(jf), _positional(tf)
    if want is None:
        return
    assert got == want, f"{module}.{name}: {got} vs the reference's {want}"
    extra = [p for p in inspect.signature(tf).parameters.values()
             if p.name not in inspect.signature(jf).parameters]
    assert all(p.kind == p.KEYWORD_ONLY for p in extra), extra


REF_METHODS = sorted(
    a for a in dir(jp.Tensor) if not a.startswith("_") and
    inspect.isfunction(getattr(jp.Tensor, a, None)))


@pytest.mark.parametrize("name", REF_METHODS)
def test_method_takes_the_references_parameters(name):
    jf, tf = getattr(jp.Tensor, name), getattr(tp.Tensor, name)
    want, got = _positional(jf), _positional(tf)
    if want is None or got is None:     # a C method of torch's: no
        return                          # signature to compare
    want, got = want[1:], got[1:]       # past self
    if jf.__name__ == "<lambda>":
        assert len(got) >= len(want) or "args" in got, (got, want)
    else:
        assert got[:len(want)] == want, (got, want)


# -- methods ------------------------------------------------------------------

M = method_cases()
X, Y = R((3, 4), 1), R((3, 4), 2)


@pytest.mark.parametrize("case", M, ids=ids(M))
def test_method_matches_the_reference(case):
    run(case, method, method)


def test_set_value_matches_the_reference():
    jx, tx = jp.to_tensor(X), tp.to_tensor(X)
    jx.set_value(Y)
    assert tx.set_value(Y) is tx
    assert_same(jx, tx)
    tx.set_value(tp.to_tensor(np.ones((3, 4), np.float64)))
    assert tx.dtype == torch.float32 and float(tx.sum()) == 12.0


def test_in_place_method_on_a_leaf_takes_the_gradient():
    # the reference rebinds the leaf; the port replaces it by the op's
    # output, whose graph reaches the leaf's .grad
    w = R((3, 4), 12)
    out = {}
    for mod in (jp, tp):
        x = mod.to_tensor(X, stop_gradient=False)
        x.scale_(3.0, 1.0)
        (x * mod.to_tensor(w)).sum().backward()
        out[mod.__name__] = (x, x.grad)
    (jx, jg), (tx, tg) = out["paddle1_tpu"], out["paddle1_tpu_torch"]
    assert_same(jx, tx)
    assert_same(jg, tg)


# in-place methods on a non-leaf activation (``h = x @ W``, which
# requires grad): torch's own in-place op where it fits, else a rebinding;
# the gradients reach ``x``, ``W`` and the operand ``w``
ACTIVATION_IN_PLACE = [
    ("clip_", lambda m, h, w: h.clip_(-0.1, 0.2)),
    ("multiply_", lambda m, h, w: h.multiply_(w)),
    ("multiply_-broadcast", lambda m, h, w: h.multiply_(
        m.stack([w, w * 2.0]))),
    ("add_", lambda m, h, w: h.add_(w)),
    ("subtract_", lambda m, h, w: h.subtract_(w)),
    ("scale_", lambda m, h, w: h.scale_(3.0, 1.0)),
    ("scale_-bias-first", lambda m, h, w: h.scale_(2.0, 0.5, False)),
    ("tanh_", lambda m, h, w: h.tanh_()),
    ("zero_", lambda m, h, w: h.zero_()),
    ("fill_", lambda m, h, w: h.fill_(3.0)),
    ("scatter_", lambda m, h, w: h.scatter_(
        m.to_tensor(np.array([2, 0], np.int32)), w[:2])),
    ("reshape_", lambda m, h, w: h.reshape_([4, 3])),
    ("flatten_", lambda m, h, w: h.flatten_()),
]


def _in_place_grads(mod, call, leaf):
    x = mod.to_tensor(X, stop_gradient=False)
    W = mod.to_tensor(R((4, 4), 14), stop_gradient=False)
    w = mod.to_tensor(Y, stop_gradient=False)
    h = x if leaf else mod.matmul(x, W)
    call(mod, h, w)
    (h * mod.to_tensor(R(tuple(h.shape), 15))).sum().backward()
    return h, x.grad, W.grad, w.grad


def _same_grads(want, got, none_is_zero=False):
    for what, j, t in zip(("value", "x.grad", "W.grad", "w.grad"), want,
                          got):
        if j is None and t is not None and none_is_zero:
            np.testing.assert_array_equal(t.numpy(), 0.0, err_msg=what)
        elif j is None:
            assert t is None, what
        else:
            assert_same(j, t, what=what)


@pytest.mark.parametrize("name,call", ACTIVATION_IN_PLACE,
                         ids=[c[0] for c in ACTIVATION_IN_PLACE])
def test_in_place_method_on_an_activation_takes_the_gradient(name, call):
    # the one difference: the reference's zero_/fill_ take a constant, so
    # no gradient reaches x and W (None); torch's zero_/fill_, which the
    # port runs on an activation, pass a zero gradient back
    _same_grads(_in_place_grads(jp, call, leaf=False),
                _in_place_grads(tp, call, leaf=False),
                none_is_zero=name in ("zero_", "fill_"))


LEAF_IN_PLACE = [c for c in ACTIVATION_IN_PLACE if c[0] in (
    "clip_", "multiply_", "add_", "subtract_", "scale_",
    "scale_-bias-first")]


@pytest.mark.parametrize("name,call", LEAF_IN_PLACE,
                         ids=[c[0] for c in LEAF_IN_PLACE])
def test_in_place_method_on_a_leaf_takes_both_gradients(name, call):
    # torch refuses the write into a leaf that requires grad: the leaf is
    # rebound, and the op reads a copy, so ``w``'s gradient sees the
    # leaf's old value
    _same_grads(_in_place_grads(jp, call, leaf=True),
                _in_place_grads(tp, call, leaf=True))


def test_rebinding_a_tensor_an_earlier_graph_saved_raises_at_backward():
    # the reference's earlier graph keeps the old value; the port's reads
    # the tensor itself, so its backward raises rather than use the new
    # value (as after torch's own in-place ops)
    x = tp.to_tensor(X, stop_gradient=False)
    w = tp.to_tensor(Y, stop_gradient=False)
    y = x * w
    x.scale_(2.0)
    with pytest.raises(RuntimeError, match="inplace"):
        y.sum().backward()


def test_setitem_into_a_leaf_that_requires_grad_matches_the_reference():
    w = R((3, 4), 13)
    out = {}
    for mod in (jp, tp):
        x = mod.to_tensor(X, stop_gradient=False)
        x[0] = 5.0
        (x * mod.to_tensor(w)).sum().backward()
        out[mod.__name__] = (x, x.grad)
    (jx, jg), (tx, tg) = out["paddle1_tpu"], out["paddle1_tpu_torch"]
    assert_same(jx, tx)
    assert_same(jg, tg)


def test_retain_grads_and_persistable():
    jx = jp.to_tensor(X, stop_gradient=False)
    tx = tp.to_tensor(X, stop_gradient=False)
    assert tx.persistable is jx.persistable is False
    jy, ty = jx * 2.0, tx * 2.0
    jy.retain_grads()
    ty.retain_grads()
    jy.sum().backward()
    ty.sum().backward()
    assert_same(jx.grad, tx.grad)
    np.testing.assert_array_equal(ty.grad.numpy(), np.ones((3, 4)))
    with tp.utils.unique_name.guard():    # leave the layer names as
        lin = tp.nn.Linear(2, 2, device="cpu")     # they were
    assert lin.weight.persistable is True


def test_device_methods_keep_torchs_behaviour():
    x = tp.to_tensor(X)
    assert x.cpu().device.type == "cpu" and x.contiguous() is x
    assert isinstance(x.cpu(), tp.Tensor)
    assert x.T.shape == [4, 3] and x.real().shape == [3, 4]
    # torch's own code reads real/imag as its properties
    assert torch.view_as_real(tp.to_tensor(X) * 1j).shape == [3, 4, 2]
    np.testing.assert_array_equal(x.imag().numpy(), np.zeros((3, 4)))


# -- torch keeps its meaning ----------------------------------------------------

def _plain(t):
    return t.as_subclass(torch.Tensor)


def test_torch_functions_on_the_facade_keep_torchs_meaning():
    x = tp.to_tensor(R((2, 12), 20))
    px = _plain(x)
    parts = torch.split(x, 3, 1)
    assert [p.shape for p in parts] == [[2, 3]] * 4
    assert all(torch.equal(_plain(a), b) for a, b in
               zip(parts, torch.split(px, 3, 1)))
    assert len(torch.chunk(x, 5, 1)) == len(torch.chunk(px, 5, 1))
    i = torch.tensor([[0, 3], [11, 2]])
    assert torch.equal(_plain(torch.gather(x, 1, i)), torch.gather(px, 1, i))
    c = px > 0
    y = torch.zeros_like(px)
    assert torch.equal(_plain(torch.where(c, x, y)), torch.where(c, px, y))
    v, ix = torch.median(x, 1)
    pv, pix = torch.median(px, 1)
    assert torch.equal(_plain(v), pv) and torch.equal(_plain(ix), pix)
    u = torch.unique(x.round(), sorted=True, return_counts=True)
    pu = torch.unique(px.round(), sorted=True, return_counts=True)
    assert all(torch.equal(_plain(a), b) for a, b in zip(u, pu))
    assert torch.numel(x) == 24 and isinstance(torch.numel(x), int)


def test_torch_python_code_on_the_facade_keeps_torchs_meaning():
    # multi_head_attention_forward calls .transpose(0, 1), .view(...),
    # .chunk(...), .split(...) and .unsqueeze(...) with torch's arguments
    torch.manual_seed(0)
    mha = torch.nn.MultiheadAttention(8, 2)
    q = R((5, 2, 8), 21)
    plain, _ = mha(*(torch.from_numpy(q),) * 3)
    facade, _ = mha(*(tp.to_tensor(q),) * 3)
    assert isinstance(facade, tp.Tensor)
    np.testing.assert_allclose(facade.detach().numpy(),
                               plain.detach().numpy(), rtol=1e-6, atol=1e-6)
    x = tp.to_tensor(X)
    assert "Tensor" in repr(x) and str(x.T.shape) == "(4, 3)"
    assert not in_torch_code()


TORCH_FORMS = [
    ("split-dim", lambda t: t.split(3, dim=1)),
    ("split_size", lambda t: t.split(split_size=2)),
    ("transpose-ints", lambda t: t.transpose(0, 1)),
    ("gather-dim-first", lambda t: t.gather(1, torch.tensor([[0], [1],
                                                             [2]]))),
    ("index_select-dim-first", lambda t: t.index_select(
        1, torch.tensor([3, 0]))),
    ("scatter-dim-first", lambda t: t.scatter(
        0, torch.tensor([[1, 0, 2, 1]]), 9.0)),
    ("index_add-dim-first", lambda t: t.index_add(
        0, torch.tensor([1]), torch.ones(1, 4))),
    ("median-dim", lambda t: t.median(dim=0)),
    ("unique-sorted", lambda t: t.unique(sorted=True, return_counts=True)),
    ("cumsum-dim", lambda t: t.cumsum(dim=1)),
    ("view-ints", lambda t: t.view(4, 3)),
    ("expand-ints", lambda t: t.unsqueeze(0).expand(2, -1, -1)),
    ("sum-dim", lambda t: t.sum(dim=1)),
    ("add_-alpha", lambda t: t.clone().add_(t, alpha=2.0)),
    ("unsqueeze-int", lambda t: t.unsqueeze(1)),
    ("squeeze-int", lambda t: t.unsqueeze(0).squeeze(0)),
]


@pytest.mark.parametrize("name,call", TORCH_FORMS,
                         ids=[c[0] for c in TORCH_FORMS])
def test_torchs_arguments_keep_torchs_meaning(name, call):
    x = tp.to_tensor(np.round(X * 2))
    got, want = call(x), call(_plain(x))
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(_plain(g), w)


def test_plain_tensors_and_parameters_keep_torchs_methods():
    t = torch.from_numpy(R((2, 12), 22))
    assert len(t.split(3, 1)) == 4 and isinstance(t.median(1), tuple)
    assert isinstance(t.numel(), int)
    # a layer's parameter has Paddle's methods in user code, as the
    # reference's Parameter is a Tensor, and torch's under torch's code
    with tp.utils.unique_name.guard():
        p = tp.nn.Linear(4, 3, device="cpu").weight
    assert not isinstance(p, tp.Tensor)
    parts = p.split(2, 0)
    assert len(parts) == 2 and all(isinstance(q, tp.Tensor) and
                                   tuple(q.shape) == (2, 3) for q in parts)
    n = p.numel()
    assert isinstance(n, tp.Tensor) and n.dim() == 0 and int(n) == 12
    assert len(torch.split(p, 3, 1)) == 1
    assert len(torch.split(p, 2, 0)) == 2
    assert torch.nn.utils.parameters_to_vector([p]).shape == (12,)


def test_torch_utilities_on_paddle_parameters_keep_torchs_meaning():
    # torch's Python code calls the methods directly, outside torch's
    # function dispatch: ``parameters_to_vector`` calls ``param.view(-1)``,
    # ``vector_to_parameters`` ``param.numel()``
    from torch.nn.utils import parameters_to_vector, vector_to_parameters
    with tp.utils.unique_name.guard():
        model = tp.vision.models.LeNet()
    params = list(model.parameters())
    assert all(isinstance(p, tp.Parameter) for p in params)
    vec = parameters_to_vector(params)
    want = torch.cat([_plain(p).detach().reshape(-1) for p in params])
    assert torch.equal(_plain(vec).detach(), want)
    with torch.no_grad():
        vector_to_parameters(vec * 2.0, params)
    assert torch.equal(_plain(parameters_to_vector(params)).detach(),
                       want * 2.0)
    # user code is Paddle's, whatever its idiom: numel() is a 0-d tensor
    n = sum(p.numel() for p in params)
    assert isinstance(n, tp.Tensor) and n.dim() == 0 and \
        int(n) == want.numel()


HELPERS = [
    ("rank", lambda m, x: m.rank(x)),
    ("is_empty", lambda m, x: m.is_empty(x)),
    ("is_empty-empty", lambda m, x: m.is_empty(m.to_tensor(
        np.zeros((0, 3), np.float32)))),
    ("reverse", lambda m, x: m.reverse(x, 1)),
    ("reverse-list", lambda m, x: m.reverse(x, [0, 1])),
    ("tolist", lambda m, x: m.tolist(x)),
    ("crop_tensor", lambda m, x: m.crop_tensor(x, [2, None], [1, 1])),
    ("crop_tensor-default", lambda m, x: m.crop_tensor(x)),
]


@pytest.mark.parametrize("name,call", HELPERS, ids=[h[0] for h in HELPERS])
def test_top_level_helper_matches_the_reference(name, call):
    # paddle1_tpu/__init__.py:151-213
    want = call(jp, jp.to_tensor(X))
    got = call(tp, tp.to_tensor(X))
    if isinstance(want, list):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)
    else:
        assert_same(want, got)


def test_top_level_namespace_exports_the_references_ops():
    import paddle1_tpu.ops as jops
    names = [n for n in dir(jops) if not n.startswith("_") and
             callable(getattr(jops, n)) and
             getattr(getattr(jops, n), "__module__", "").startswith(
                 ("paddle1_tpu.ops.math_ops", "paddle1_tpu.ops.manip_ops",
                  "paddle1_tpu.ops.linalg_ops"))]
    assert len(names) > 200
    missing = [n for n in names if not callable(getattr(tp, n, None))]
    assert missing == []
    assert tp.matmul is tmath.matmul and tp.concat is tmanip.concat and \
        tp.linalg.norm is tl.norm
