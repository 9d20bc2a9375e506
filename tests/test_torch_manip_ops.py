"""The port's ``ops.manip_ops`` against ``paddle1_tpu/ops/manip_ops.py``:
one case per op (more for ops with modes), the same seeded numpy inputs
through both, values and dtypes compared, and gradients for
differentiable ops (``tests/test_torch_op_parity.py``). Elementwise and
shape ops are held to 1e-6 (f32, absolute and relative).

Dtype differences, each marked ``x64=True``: without x64 the JAX
package stores an int64 result as int32 (``arange`` of ints, ``full``
with an int, ``randperm``, ``numel``, ``randint``'s default).

The random ops cannot give the same numbers (jax threefry against torch
Philox): they are held to shape, dtype, support and moments (stated
tolerances), and to repeatability under ``paddle.seed`` and under a
``generator``. Creation ops place their output on the current place.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.ops import manip_ops as jm
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.ops import manip_ops as tm

from test_torch_op_parity import ELEM, R, assert_same, ids, run
from test_torch_op_cases import N, RANDOM, manip_cases


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


CASES = manip_cases()
X, Y = R((3, 4), 1), R((3, 4), 2)
IDX = np.array([2, 0], np.int32)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_manip_op_matches_the_reference(case):
    run(case, jm, tm)


@pytest.mark.parametrize("op,args", [
    ("reshape_", ([6, 2],)), ("flatten_", ()), ("scatter_", (IDX, Y[:2]))])
def test_in_place_manip_ops_replace_their_input(op, args):
    jx, tx = jp.to_tensor(X), tp.to_tensor(X)
    jargs = [jp.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [tp.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    jo, to = getattr(jm, op)(jx, *jargs), getattr(tm, op)(tx, *targs)
    assert to is tx
    assert_same(jo, to)
    assert_same(jx, tx)


def test_in_place_op_on_a_leaf_takes_the_gradient_like_the_reference():
    # the reference rebinds the leaf to the op's output: a loss on it
    # reaches the leaf's .grad through the op
    w, u = R((3, 4), 31), R((2, 4), 32)
    jx = jp.to_tensor(X, stop_gradient=False)
    tx = tp.to_tensor(X, stop_gradient=False)
    jm.scatter_(jx, jp.to_tensor(IDX), jp.to_tensor(u))
    tm.scatter_(tx, tp.to_tensor(IDX), tp.to_tensor(u))
    assert_same(jx, tx)
    (jx * jp.to_tensor(w)).sum().backward()
    (tx * tp.to_tensor(w)).sum().backward()
    assert_same(jx.grad, tx.grad)


def test_in_place_reshape_of_a_leaf_that_requires_grad_raises():
    # torch accumulates a leaf's gradient in the leaf's own shape
    from paddle1_tpu_torch.core.errors import PreconditionNotMetError
    tx = tp.to_tensor(X, stop_gradient=False)
    with pytest.raises(PreconditionNotMetError):
        tm.reshape_(tx, [4, 3])
    with tp.no_grad():
        assert tm.reshape_(tx, [4, 3]).shape == [4, 3]


def test_assign_into_output_matches_the_reference():
    jo, to = jp.to_tensor(Y), tp.to_tensor(Y)
    jm.assign(jp.to_tensor(X), jo)
    assert tm.assign(tp.to_tensor(X), to) is to
    assert_same(jo, to)


def test_creation_ops_follow_the_current_place():
    for out in (tm.zeros([2]), tm.arange(3), tm.eye(2), tm.full([1], 2.0),
                tm.rand([2]), tm.randn([2]), tm.randint(0, 4, [2]),
                tm.randperm(3), tm.linspace(0, 1, 3)):
        assert isinstance(out, tp.Tensor) and out.device.type == "cpu"
        assert out.stop_gradient


def test_split_refuses_an_axis_it_cannot_cut_evenly():
    with pytest.raises(InvalidArgumentError):
        tm.split(tp.to_tensor(X), 3, 1)


# -- random ops: shape, dtype, support, moments, repeatability --------------

class _JaxNs:
    """The JAX package's random ops with ``to_tensor`` beside them."""
    def __getattr__(self, name):
        return jp.to_tensor if name == "to_tensor" else getattr(jm, name)


class _PortNs:
    def __getattr__(self, name):
        return tp.to_tensor if name == "to_tensor" else getattr(tm, name)


@pytest.mark.parametrize("name,draw,support,moments", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_op_matches_the_reference_in_distribution(name, draw, support,
                                                         moments):
    jp.seed(7)
    tp.seed(7)
    j, t = draw(_JaxNs()), draw(_PortNs())
    jd, td = np.dtype(j.dtype).name, str(t.dtype).replace("torch.", "")
    assert jd == td or (jd, td) == ("int32", "int64"), (jd, td)
    a, b = np.asarray(j.numpy()).astype(np.float64), t.numpy().astype(
        np.float64)
    assert a.shape == b.shape
    if support is not None:
        assert b.min() >= support[0] and b.max() <= support[1]
    mean, var = moments
    # 20000 draws: the sample moments lie within 5 standard errors
    for got in (a, b):
        se = np.sqrt(var / got.size)
        assert abs(got.mean() - mean) <= 5 * se + 1e-9, (got.mean(), mean)
        assert abs(got.var() - var) <= 0.05 * var + 1e-9, (got.var(), var)
    if name == "randperm":
        assert sorted(b.astype(np.int64).tolist()) == list(range(N))


@pytest.mark.parametrize("name,draw", [(r[0], r[1]) for r in RANDOM],
                         ids=[r[0] for r in RANDOM])
def test_random_op_repeats_under_seed_and_generator(name, draw):
    ns = _PortNs()
    tp.seed(11)
    first = draw(ns).numpy()
    tp.seed(11)
    np.testing.assert_array_equal(draw(ns).numpy(), first)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    tp.seed(12)
    a = draw(ns, generator=g1).numpy()
    tp.seed(13)     # the global state does not reach a given generator
    np.testing.assert_array_equal(draw(ns, generator=g2).numpy(), a)


def test_uniform_seed_is_a_stream_of_its_own_like_the_reference():
    tp.seed(1)
    a = tm.uniform([5], seed=3).numpy()
    tp.seed(2)
    np.testing.assert_array_equal(tm.uniform([5], seed=3).numpy(), a)
    jp.seed(1)
    ja = np.asarray(jm.uniform([5], seed=3).numpy())
    jp.seed(2)
    np.testing.assert_array_equal(np.asarray(jm.uniform([5], seed=3).numpy()),
                                  ja)


def test_normal_with_tensor_moments_takes_their_shape():
    m = np.full((2, 3), 4.0, np.float32)
    jo = jm.normal(jp.to_tensor(m), 0.0)
    to = tm.normal(tp.to_tensor(m), 0.0)
    assert_same(jo, to, ELEM)
