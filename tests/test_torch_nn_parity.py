"""The nn slice against the JAX package on the CPU: every functional case
of ``tests/test_torch_nn_cases.py`` (each name of ``nn/functional/
{activation,norm,loss}.py``) through both packages on the same seeded
numpy inputs; values and dtypes, the gradients of a weighted sum of the
first output with respect to the listed inputs, and the tensors updated
in place (running statistics, the ``*_`` activations); the inventory of
all five modules (``nn/layer_norm_act.py`` and ``nn/layer_loss.py`` too),
the positional signatures, the random draws by distribution and the AMP
lists. The layers' cases run in ``tests/test_torch_nn_layer_parity.py``.
Tolerances are each case's (``ELEM`` 1e-6, ``RED`` 1e-5, ``LINALG`` 1e-4,
f32).
"""

import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.nn import functional as jF
from paddle1_tpu_torch.nn import functional as tF

from test_torch_nn_cases import (RANDOM, activation_cases, layer_cases,
                                 loss_cases, norm_cases, random_check)
from test_torch_op_cases import R, ids
from test_torch_op_parity import port_np, run


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


FUNCTIONAL = activation_cases() + norm_cases() + loss_cases()
LAYERS = layer_cases()


@pytest.mark.parametrize("case", FUNCTIONAL, ids=ids(FUNCTIONAL))
def test_functional_matches_the_reference(case):
    run(case, jF, tF)


def _names(module):
    return set(module.__all__)


@pytest.mark.parametrize("pair", [
    ("paddle1_tpu.nn.functional.activation",
     "paddle1_tpu_torch.nn.functional.activation"),
    ("paddle1_tpu.nn.functional.norm", "paddle1_tpu_torch.nn.functional.norm"),
    ("paddle1_tpu.nn.functional.loss", "paddle1_tpu_torch.nn.functional.loss"),
    ("paddle1_tpu.nn.layer_norm_act", "paddle1_tpu_torch.nn.layer_norm_act"),
    ("paddle1_tpu.nn.layer_loss", "paddle1_tpu_torch.nn.layer_loss"),
], ids=["activation", "norm", "loss", "layer_norm_act", "layer_loss"])
def test_every_name_is_ported_and_exported_with_a_case(pair):
    """Each name of the JAX module's ``__all__`` is in the port's module,
    in ``paddle.nn`` / ``paddle.nn.functional`` as in the JAX package,
    and has a case here (containers and ``collect_stat_updates`` have
    their own tests)."""
    import importlib
    jm, tm = (importlib.import_module(p) for p in pair)
    assert _names(jm) <= _names(tm), sorted(_names(jm) - _names(tm))
    is_layer = "layer_" in pair[0]
    top_j = jp.nn if is_layer else jp.nn.functional
    top_t = tp.nn if is_layer else tp.nn.functional
    covered = {c.op for c in (LAYERS if is_layer else FUNCTIONAL)}
    covered |= {r[0] for r in RANDOM}
    own_tests = {"Sequential", "LayerList", "ParameterList", "LayerDict",
                 "collect_stat_updates"}
    for name in _names(jm):
        assert hasattr(top_j, name) and hasattr(top_t, name), name
        assert name in covered | own_tests, f"{name} has no case"


@pytest.mark.parametrize("name", sorted(
    set(jp.nn.functional.activation.__all__) |
    set(jp.nn.functional.norm.__all__) | set(jp.nn.functional.loss.__all__)
    - {"collect_stat_updates"}))
def test_functional_positional_parameters_are_the_reference_s(name):
    """The reference's parameters in its positions, port-only ones
    keyword-only after them."""
    jsig = inspect.signature(getattr(jF, name))
    tsig = inspect.signature(getattr(tF, name))
    want = [(p.name, p.default) for p in jsig.parameters.values()]
    got = [(p.name, p.default) for p in tsig.parameters.values()
           if p.kind != p.KEYWORD_ONLY]
    assert got == want


@pytest.mark.parametrize("name,draw", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_activation_draws_match_the_reference_s_distribution(name,
                                                                    draw):
    jp.seed(7)
    random_check(name, np.asarray(draw(jF, jp.to_tensor).numpy()))
    g = torch.Generator().manual_seed(7)
    got = draw(tF, tp.to_tensor, generator=g)
    random_check(name, port_np(got))
    again = draw(tF, tp.to_tensor, generator=torch.Generator().manual_seed(7))
    assert torch.equal(got, again)


def test_gumbel_softmax_hard_passes_the_soft_gradient():
    x = tp.to_tensor(R((5, 4), 120), stop_gradient=False)
    g = torch.Generator().manual_seed(1)
    y = tF.gumbel_softmax(x, 1.0, hard=True, generator=g)
    np.testing.assert_array_equal(port_np(y).sum(-1), np.ones(5))
    (y * tp.to_tensor(R((5, 4), 121))).sum().backward()
    soft = tF.gumbel_softmax(
        tp.to_tensor(R((5, 4), 120), stop_gradient=False), 1.0,
        generator=torch.Generator().manual_seed(1))
    assert torch.allclose(torch.argmax(soft, -1), torch.argmax(y, -1))
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_rrelu_layer_draws_in_training_and_averages_in_eval():
    layer = tp.nn.RReLU(0.1, 0.3, generator=torch.Generator().manual_seed(3))
    x = tp.to_tensor(-np.ones(1000, np.float32))
    y = port_np(layer(x))
    assert y.min() >= -0.3 - 1e-6 and y.max() <= -0.1 + 1e-6
    assert len(np.unique(y)) > 100
    layer.eval()
    np.testing.assert_allclose(port_np(layer(x)), -0.2, rtol=1e-6)


@pytest.mark.parametrize("name", ["relu6", "gelu", "prelu", "hardswish",
                                  "mse_loss", "group_norm"])
def test_a_custom_list_names_the_op_as_in_the_reference(name):
    """``auto_cast(custom_white_list=[name])`` casts the op to the AMP
    dtype in both packages; without it the op keeps f32."""
    x = R((2, 8, 2, 2), 130)
    calls = {"relu6": lambda F, t: F.relu6(t(x)),
             "gelu": lambda F, t: F.gelu(t(x)),
             "prelu": lambda F, t: F.prelu(t(x), t(np.float32([0.2]))),
             "hardswish": lambda F, t: F.hardswish(t(x)),
             "mse_loss": lambda F, t: F.mse_loss(t(x), t(x * 2)),
             "group_norm": lambda F, t: F.group_norm(t(x), 2)}
    for pkg, F in ((jp, jF), (tp, tF)):
        with pkg.amp.auto_cast(custom_white_list=[name]):
            out = calls[name](F, pkg.to_tensor)
        assert "bfloat16" in str(out.dtype), (pkg.__name__, out.dtype)
        with pkg.amp.auto_cast():
            out = calls[name](F, pkg.to_tensor)
        assert "float32" in str(out.dtype), (pkg.__name__, out.dtype)
