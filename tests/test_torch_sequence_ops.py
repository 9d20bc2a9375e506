"""The port's ``ops.sequence_ops`` against ``paddle1_tpu/ops/
sequence_ops.py`` on the CPU: every case of ``sequence_cases``
(``tests/test_torch_op_cases.py``) through both packages on the same
seeded numpy inputs (values, dtypes, gradients of the listed inputs),
where host input lands (the current place, mocked as the meta device), the
inventory (all 18 names, exported at the top level as the JAX package
exports them) with the reference's positional signatures, and the
contract errors both packages raise. Tolerances are each case's (``ELEM``
1e-6, ``RED`` 1e-5, f32); ``x64`` marks the int64 results the JAX package
keeps as int32.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.ops import sequence_ops as js
from paddle1_tpu_torch.ops import sequence_ops as ts

from test_torch_op_cases import R, ids, sequence_cases
from test_torch_op_parity import run


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


CASES = sequence_cases()


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_sequence_op_matches_the_reference(case):
    run(case, js, ts)


def test_every_sequence_op_is_ported_exported_and_has_a_case():
    assert ts.__all__ == js.__all__
    covered = {c.op for c in CASES}
    for name in js.__all__:
        assert getattr(tp, name) is getattr(ts, name), name
        assert getattr(tp.ops, name) is getattr(ts, name), name
        assert name in tp.__all__, name
        assert name in covered, f"{name} has no case"


@pytest.mark.parametrize("name", js.__all__)
def test_sequence_op_positional_parameters_are_the_reference_s(name):
    def pos(fn):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()]
    assert pos(getattr(ts, name)) == pos(getattr(js, name))


@pytest.mark.parametrize("call", [
    lambda m: m.sequence_reshape(R((2, 3, 4), 1), np.array([3, 1], np.int32),
                                 8),
    lambda m: m.sequence_slice(R((2, 3, 4), 2), np.array([1, 2]),
                               np.array([3, 1])),
], ids=["reshape-ragged-tail", "slice-past-the-end"])
def test_sequence_contract_errors_are_the_reference_s(call):
    with pytest.raises(ValueError):
        call(js)
    with pytest.raises(ValueError):
        call(ts)


class _MetaPlace:
    """A current place whose device is ``meta``: host data that an op
    sends to the current place shows up there, not on the CPU."""

    def torch_device(self):
        return torch.device("meta")


@pytest.fixture
def meta_place(monkeypatch):
    from paddle1_tpu_torch.core import place, tensor
    for mod in (place, tensor):
        monkeypatch.setattr(mod, "get_device", _MetaPlace)


_DENSE = R((2, 5, 3), 900)
_LEN = np.array([3, 5], np.int64)


@pytest.mark.parametrize("call", [
    lambda: ts.sequence_mask(_LEN, maxlen=6),
    lambda: ts.sequence_pool(_DENSE, _LEN, "sum"),
    lambda: ts.sequence_pool(_DENSE, _LEN, "max"),
    lambda: ts.sequence_softmax(_DENSE[..., 0], _LEN),
    lambda: ts.sequence_first_step(_DENSE, _LEN),
    lambda: ts.sequence_reverse(_DENSE, _LEN),
], ids=["mask", "pool_sum", "pool_max", "softmax", "first_step",
        "reverse"])
def test_host_input_lands_on_the_current_place(meta_place, call):
    assert call().device.type == "meta"
