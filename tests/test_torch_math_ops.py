"""The port's ``ops.math_ops`` against ``paddle1_tpu/ops/math_ops.py``:
one case per op (more for ops with modes), the same seeded numpy inputs
through both, values and dtypes compared, and gradients for
differentiable ops (``tests/test_torch_op_parity.py``).

Tolerances (f32, absolute and relative): elementwise 1e-6, reductions
1e-5, products (``matmul`` and kin) 1e-5, stated per case. Dtype
differences, each marked ``x64=True``: the JAX package runs without x64,
so an int64 result (the sum of bools, ``argmax``, ``argmin``, ``argsort``, ``topk``'s
indices, ``nonzero``, ``searchsorted``, ``unique``'s indices and counts,
``bincount``, ``histogram``, ``mode``'s index) is int32 there and int64
in the port, and a float64 one (``sum(dtype="float64")``) is float32.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu_torch as tp
from paddle1_tpu.ops import math_ops as jm
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.ops import math_ops as tm

from test_torch_op_parity import ELEM, R, assert_same, ids, run
from test_torch_op_cases import math_cases


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


CASES = math_cases()
X, Y, I1 = R((3, 4), 1), R((3, 4), 2), R((3, 4), 5, "i")


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_math_op_matches_the_reference(case):
    run(case, jm, tm)


@pytest.mark.parametrize("op", ["increment", "tanh_"])
def test_in_place_math_ops_write_into_their_input(op):
    import paddle1_tpu as jp
    jx, tx = jp.to_tensor(X), tp.to_tensor(X)
    jo = getattr(jm, op)(jx)
    to = getattr(tm, op)(tx)
    assert to is tx
    assert_same(jo, to)
    assert_same(jx, tx)


def test_is_tensor_matches_the_reference():
    import paddle1_tpu as jp
    assert tm.is_tensor(tp.to_tensor(X)) and jm.is_tensor(jp.to_tensor(X))
    assert not tm.is_tensor(X) and not jm.is_tensor(X)


def test_matmul_int8_refuses_float_and_mismatched_inputs():
    with pytest.raises(InvalidArgumentError):
        tm.matmul_int8(tp.to_tensor(X), tp.to_tensor(Y.T))
    with pytest.raises(InvalidArgumentError):
        tm.matmul_int8(tp.to_tensor(I1), tp.to_tensor(I1))


def test_mm_refuses_to_broadcast_like_the_reference():
    from paddle1_tpu.core.errors import InvalidArgumentError as JErr
    a, b = R((2, 3, 4), 43), R((4, 5), 44)
    import paddle1_tpu as jp
    with pytest.raises(JErr):
        jm.mm(jp.to_tensor(a), jp.to_tensor(b))
    with pytest.raises(InvalidArgumentError):
        tm.mm(tp.to_tensor(a), tp.to_tensor(b))


def test_plain_torch_tensors_go_through_the_namespace_plainly():
    a = torch.from_numpy(X.copy())
    out = tm.add(a, 1.0)
    assert type(out) is torch.Tensor
    np.testing.assert_allclose(out.numpy(), X + 1.0, rtol=ELEM)
