"""``nn/functional/pooling.py`` and the pooling layers of
``nn/layer_conv_pool.py`` against the JAX package on the CPU: every
``pooling_cases`` / ``pooling_layer_cases`` case of
``tests/test_torch_nn_cases.py`` through both packages on the same seeded
numpy inputs (values, dtypes, the gradients of the listed inputs and of
``Conv2D``'s parameters), the inventory with the reference's positional
signatures, ``divisor_override`` taken and not read, and ``return_mask``
into ``max_unpool2d`` round trips on tied windows. Tolerances are each
case's (``ELEM`` 1e-6, ``RED`` 1e-5, f32); indices compare exactly (the
JAX package's int64 is int32 without x64).
"""

import importlib
import inspect

import numpy as np
import pytest

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.nn import functional as jF
from paddle1_tpu_torch.nn import functional as tF

from test_torch_nn_cases import _ties, pooling_cases, pooling_layer_cases
from test_torch_nn_layer_parity import test_layer_matches_the_reference
from test_torch_op_cases import R, ids
from test_torch_op_parity import port_np, run


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


FUNCTIONAL = pooling_cases()
LAYERS = pooling_layer_cases()


@pytest.mark.parametrize("case", FUNCTIONAL, ids=ids(FUNCTIONAL))
def test_pooling_functional_matches_the_reference(case):
    run(case, jF, tF)


@pytest.mark.parametrize("case", LAYERS, ids=ids(LAYERS))
def test_pooling_layer_matches_the_reference(case):
    test_layer_matches_the_reference(case)


POOL_LAYERS = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
               "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D",
               "AdaptiveAvgPool2D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
               "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "MaxUnPool2D"]


def test_every_pooling_name_is_ported_and_exported_with_a_case():
    jm = importlib.import_module("paddle1_tpu.nn.functional.pooling")
    tm = importlib.import_module("paddle1_tpu_torch.nn.functional.pooling")
    assert set(jm.__all__) <= set(tm.__all__)
    covered = {c.op for c in FUNCTIONAL}
    for name in jm.__all__:
        assert getattr(tF, name) is getattr(tm, name)
        assert name in covered, f"{name} has no case"
    layers = {c.op for c in LAYERS}
    jl = importlib.import_module("paddle1_tpu.nn.layer_conv_pool")
    for name in POOL_LAYERS:
        assert hasattr(jl, name) and hasattr(tp.nn, name), name
        assert name in layers, f"{name} has no case"


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind != p.KEYWORD_ONLY]


@pytest.mark.parametrize("name", sorted(jp.nn.functional.pooling.__all__))
def test_pooling_functional_positional_parameters_are_the_reference_s(name):
    assert _positional(getattr(tF, name)) == _positional(getattr(jF, name))


@pytest.mark.parametrize("name", POOL_LAYERS)
def test_pooling_layer_positional_parameters_are_the_reference_s(name):
    assert _positional(getattr(tp.nn, name).__init__) == \
        _positional(getattr(jp.nn, name).__init__)


@pytest.mark.parametrize("fn", ["avg_pool2d", "avg_pool3d"])
def test_divisor_override_is_taken_and_not_read_as_in_the_reference(fn):
    """Both packages divide by the window's real cells whatever
    ``divisor_override`` says (Paddle's reference divides by it)."""
    x = R((1, 2, 4, 4, 4), 215)[:, :, 0] if fn == "avg_pool2d" else \
        R((1, 2, 4, 4, 4), 215)
    for pkg, F in ((jp, jF), (tp, tF)):
        plain = getattr(F, fn)(pkg.to_tensor(x), 2)
        over = getattr(F, fn)(pkg.to_tensor(x), 2, divisor_override=1)
        np.testing.assert_array_equal(port_np(over) if pkg is tp else
                                      np.asarray(over.numpy()),
                                      port_np(plain) if pkg is tp else
                                      np.asarray(plain.numpy()))


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_max_pool_mask_into_unpool_round_trips_on_ties(data_format):
    """``return_mask`` picks each window's first maximum (the lowest flat
    index) in both packages; unpooling puts every maximum back in place
    and zeros elsewhere."""
    x = _ties((2, 3, 6, 4), 216)
    xin = x if data_format == "NCHW" else np.moveaxis(x, 1, -1).copy()
    outs = []
    for pkg, F in ((jp, jF), (tp, tF)):
        out, mask = F.max_pool2d(pkg.to_tensor(xin), 2, return_mask=True,
                                 data_format=data_format)
        o, m = (np.asarray(t.numpy()) for t in (out, mask))
        if data_format == "NHWC":
            o, m = np.moveaxis(o, -1, 1), np.moveaxis(m, -1, 1)
        back = F.max_unpool2d(pkg.to_tensor(o), pkg.to_tensor(
            m.astype(np.int32)), 2)
        outs.append((o, m.astype(np.int64), np.asarray(back.numpy())))
    (jo, jm, jb), (to, tm, tb) = outs
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tb, jb)
    # the first maximum of each tied window
    flat = x.reshape(2, 3, -1)
    for (n, c, i, j), idx in np.ndenumerate(tm):
        win = [(2 * i + a) * 4 + 2 * j + b for a in (0, 1) for b in (0, 1)]
        vals = flat[n, c, win]
        assert idx == win[int(np.argmax(vals))]
    kept = tb != 0
    np.testing.assert_array_equal(tb[kept], x[kept])


def test_max_pool2d_mask_gradient_is_the_reference_s_on_ties():
    """The gradient of a tied window goes to its first maximum in both
    packages."""
    x = _ties((1, 2, 4, 4), 217)
    grads = []
    for pkg, F in ((jp, jF), (tp, tF)):
        t = pkg.to_tensor(x)
        t.stop_gradient = False
        F.max_pool2d(t, 2).sum().backward()
        grads.append(np.asarray(t.grad.numpy()) if pkg is jp else
                     port_np(t.grad))
    np.testing.assert_array_equal(grads[1], grads[0])
    assert grads[1].sum() == 2 * 4
