"""``nn/functional/common.py`` (with ``unfold``/``fold`` of ``conv.py``)
and ``nn/layer_common.py`` against the JAX package on the CPU: every
``common_cases`` / ``common_layer_cases`` case of
``tests/test_torch_nn_cases.py`` through both packages on the same seeded
numpy inputs (values, dtypes, the gradients of the listed inputs and of
every parameter, the layers' state carried across by
``convert.state_from_jax``), the inventory of both modules with the
reference's positional signatures, and ``embedding``'s contract at the
padding row. Tolerances are each case's (``ELEM`` 1e-6, ``RED`` 1e-5,
f32).
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.nn import functional as jF
from paddle1_tpu_torch.core.errors import InvalidArgumentError, UnimplementedError
from paddle1_tpu_torch.nn import functional as tF

from test_torch_nn_cases import common_cases, common_layer_cases
from test_torch_nn_layer_parity import test_layer_matches_the_reference
from test_torch_op_cases import R, ids
from test_torch_op_parity import port_np, run


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


FUNCTIONAL = common_cases()
LAYERS = common_layer_cases()


@pytest.mark.parametrize("case", FUNCTIONAL, ids=ids(FUNCTIONAL))
def test_common_functional_matches_the_reference(case):
    run(case, jF, tF)


@pytest.mark.parametrize("case", LAYERS, ids=ids(LAYERS))
def test_common_layer_matches_the_reference(case):
    test_layer_matches_the_reference(case)


MODULES = [("paddle1_tpu.nn.functional.common",
            "paddle1_tpu_torch.nn.functional.common"),
           ("paddle1_tpu.nn.layer_common", "paddle1_tpu_torch.nn.layer_common")]


@pytest.mark.parametrize("pair", MODULES, ids=["common", "layer_common"])
def test_every_common_name_is_ported_and_exported_with_a_case(pair):
    jm, tm = (importlib.import_module(p) for p in pair)
    missing = set(jm.__all__) - set(tm.__all__)
    assert not missing, sorted(missing)
    is_layer = "layer_" in pair[0]
    top_t = tp.nn if is_layer else tp.nn.functional
    covered = {c.op for c in (LAYERS if is_layer else FUNCTIONAL)}
    from test_torch_nn_cases import RANDOM
    covered |= {r[0] for r in RANDOM}
    for name in jm.__all__:
        assert hasattr(top_t, name), name
        assert name in covered, f"{name} has no case"


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind != p.KEYWORD_ONLY]


@pytest.mark.parametrize("name", sorted(
    set(jp.nn.functional.common.__all__) | {"unfold", "fold"}))
def test_common_functional_positional_parameters_are_the_reference_s(name):
    assert _positional(getattr(tF, name)) == \
        _positional(getattr(jF, name))


@pytest.mark.parametrize("name", sorted(jp.nn.layer_common.__all__))
def test_common_layer_positional_parameters_are_the_reference_s(name):
    jsig = _positional(getattr(jp.nn, name).__init__)
    tsig = _positional(getattr(tp.nn, name).__init__)
    assert [n for n, _ in tsig] == [n for n, _ in jsig]
    assert tsig == jsig


def test_embedding_padding_row_has_no_output_and_no_gradient():
    ids_ = np.array([[1, 0, 3], [0, 2, 1]], np.int32)
    w = R((4, 3), 300)
    outs = []
    for pkg, F in ((jp, jF), (tp, tF)):
        wt = pkg.to_tensor(w, stop_gradient=False)
        out = F.embedding(pkg.to_tensor(ids_), wt, padding_idx=0)
        (out * pkg.to_tensor(R((2, 3, 3), 301))).sum().backward()
        outs.append((np.asarray(out.numpy()), np.asarray(wt.grad.numpy())))
    (jo, jg), (to, tg) = outs
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-6)
    assert not to[ids_ == 0].any() and not tg[0].any()


def test_embedding_sparse_raises_naming_the_roadmap_item():
    with pytest.raises(UnimplementedError, match="item 8"):
        tF.embedding(tp.to_tensor(np.array([1], np.int32)),
                     tp.to_tensor(R((3, 2), 302)), sparse=True)


@pytest.mark.parametrize("mode,corners", [("bilinear", False),
                                          ("bicubic", True), ("area", False)])
def test_interpolate_unported_modes_raise(mode, corners):
    """A mode neither package knows raises, here a misspelling of each
    mode that once raised as unported. Those modes run now: the port's
    result has the asked shape, and ``test_torch_conv_nd`` holds every
    mode to the JAX package's resize."""
    x = tp.to_tensor(R((1, 1, 2, 2), 303))
    with pytest.raises(InvalidArgumentError):
        tF.interpolate(x, size=[3, 3], mode=mode + "x",
                       align_corners=corners)
    with pytest.raises(KeyError):
        jp.nn.functional.interpolate(jp.to_tensor(R((1, 1, 2, 2), 303)),
                                     size=[3, 3], mode=mode + "x",
                                     align_corners=corners)
    got = tF.interpolate(x, size=[3, 3], mode=mode, align_corners=corners)
    assert tuple(got.shape) == (1, 1, 3, 3)


def test_top_level_names_whose_modules_exist():
    for name in ("DataParallel", "set_flags", "get_flags", "in_dynamic_mode",
                 "is_compiled_with_cuda", "create_parameter",
                 "set_printoptions", "get_cuda_rng_state",
                 "set_cuda_rng_state", "promote_types"):
        assert hasattr(tp, name) and hasattr(jp, name), name
    assert tp.in_dynamic_mode() is True
    assert tp.promote_types("float16", "float32") == tp.float32
    assert str(jp.promote_types("float16", "float32")) == "float32"
    assert tp.get_flags("fused_adam") == {"fused_adam": "auto"} or \
        "fused_adam" in tp.get_flags("fused_adam")
    p = tp.create_parameter([2, 3], "float32")
    assert list(p.shape) == [2, 3] and not p.stop_gradient
    state = tp.get_cuda_rng_state()
    a = torch.rand(2)
    tp.set_cuda_rng_state(state)
    assert torch.equal(torch.rand(2), a)
    assert tp.nn.ParamAttr is tp.ParamAttr
