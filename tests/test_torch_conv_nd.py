"""The N-d and transposed convolutions, their layers, VGG and
``interpolate``'s resize modes against the JAX package on the CPU.

* every ``conv_cases`` / ``conv_layer_cases`` case of
  ``tests/test_torch_nn_cases.py`` through both packages (values, the
  gradients of the listed inputs and of every parameter; ``RED`` 1e-5,
  f32 sums of up to 72 products), the inventory of ``conv.py`` and the
  conv layers with the reference's positional signatures;
* ``vgg11`` and ``vgg16(batch_norm=True)`` (the feature extractor and
  pool, ``num_classes=0``: the head is three ``Linear``s of 120 M
  parameters, held on the card by ``chip_smoke.py``) at 2 x 32², the
  forward in training mode and one eager ``Momentum`` step, within 1e-4
  (13-16 layers of f32 convolutions), and the state names of the full
  VGG16-BN;
* ``interpolate`` in every resize mode, up and down, at integer and
  non-integer factors, with and without ``align_corners`` and in both
  data formats, value and gradient within 1e-5.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.nn import functional as jF
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.nn import functional as tF

from test_torch_nn_cases import conv_cases, conv_layer_cases
from test_torch_nn_layer_parity import test_layer_matches_the_reference
from test_torch_op_cases import R, ids
from test_torch_op_parity import run


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


FUNCTIONAL = conv_cases()
LAYERS = conv_layer_cases()
CONV_LAYERS = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
               "Conv2DTranspose", "Conv3DTranspose"]


@pytest.mark.parametrize("case", FUNCTIONAL, ids=ids(FUNCTIONAL))
def test_conv_functional_matches_the_reference(case):
    run(case, jF, tF)


@pytest.mark.parametrize("case", LAYERS, ids=ids(LAYERS))
def test_conv_layer_matches_the_reference(case):
    test_layer_matches_the_reference(case)


def test_every_conv_name_is_ported_exported_and_has_a_case():
    jm = importlib.import_module("paddle1_tpu.nn.functional.conv")
    tm = importlib.import_module("paddle1_tpu_torch.nn.functional.conv")
    assert tm.__all__ == jm.__all__
    covered = {c.op for c in FUNCTIONAL} | {"unfold", "fold"}
    for name in jm.__all__:
        assert getattr(tF, name) is getattr(tm, name), name
        assert name in covered, f"{name} has no case"
    layers = {c.op for c in LAYERS} | {"Conv2D"}
    for name in CONV_LAYERS:
        assert name in importlib.import_module(
            "paddle1_tpu_torch.nn.layer_conv_pool").__all__
        assert name in layers, f"{name} has no case"


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind != p.KEYWORD_ONLY]


@pytest.mark.parametrize("name", sorted(
    importlib.import_module("paddle1_tpu.nn.functional.conv").__all__))
def test_conv_functional_positional_parameters_are_the_reference_s(name):
    assert _positional(getattr(tF, name)) == _positional(getattr(jF, name))


@pytest.mark.parametrize("name", CONV_LAYERS)
def test_conv_layer_positional_parameters_are_the_reference_s(name):
    assert _positional(getattr(tp.nn, name).__init__) == \
        _positional(getattr(jp.nn, name).__init__)


# ---------------------------------------------------------------------------
# VGG


def _vgg_pair(name, batch_norm):
    from paddle1_tpu.vision.models import vgg as jvgg
    from paddle1_tpu_torch.vision.models import vgg as tvgg
    jp.seed(7)
    jm = getattr(jvgg, name)(batch_norm=batch_norm, num_classes=0)
    with tp.utils.unique_name.guard():
        tm = getattr(tvgg, name)(batch_norm=batch_norm, num_classes=0,
                                 device="cpu")
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state_from_jax(state, tm))
    return jm, tm


@pytest.mark.parametrize("name,bn", [("vgg11", False), ("vgg16", True)])
def test_vgg_forward_and_one_momentum_step_match_the_reference(name, bn):
    jm, tm = _vgg_pair(name, bn)
    assert sum(k.endswith("._mean") for k in tm.state_dict()) == \
        (13 if bn else 0)
    x = R((2, 3, 32, 32), 90)
    outs = []
    for pkg, m in ((jp, jm), (tp, tm)):
        m.train()
        opt = pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=m.parameters())
        y = m(pkg.to_tensor(x))
        loss = (y * y).mean()
        loss.backward()
        opt.step()
        outs.append((np.asarray(y.numpy()), float(loss.numpy())))
    (jy, jl), (ty, tl) = outs
    assert ty.shape == (2, 512, 7, 7)
    np.testing.assert_allclose(ty, jy, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    js = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), js[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_vgg16_bn_state_names_are_the_reference_s():
    from paddle1_tpu_torch.vision.models import vgg16, VGG
    with tp.utils.unique_name.guard():
        m = vgg16(batch_norm=True, num_classes=10, device="cpu")
    assert isinstance(m, VGG)
    names = set(m.state_dict())
    assert "features.1._mean" in names and "classifier.6.weight" in names
    assert tuple(m.classifier[0].weight.shape) == (512 * 7 * 7, 4096)
    assert sum(k.endswith("._mean") for k in names) == 13
    with pytest.raises(NotImplementedError):
        vgg16(pretrained=True)


# ---------------------------------------------------------------------------
# interpolate's resize modes


SIZES = [{"scale_factor": 2}, {"scale_factor": 0.5},
         {"scale_factor": 1.7}, {"scale_factor": 0.45}]


@pytest.mark.parametrize("corners", [False, True], ids=["half", "corners"])
@pytest.mark.parametrize("size", SIZES, ids=["x2", "x0.5", "x1.7", "x0.45"])
@pytest.mark.parametrize("mode,shape,fmt", [
    ("linear", (2, 3, 11), "NCW"), ("bilinear", (2, 3, 9, 11), "NCHW"),
    ("bilinear", (2, 9, 11, 3), "NHWC"), ("bicubic", (2, 3, 9, 11), "NCHW"),
    ("area", (2, 3, 9, 11), "NCHW"), ("trilinear", (1, 2, 5, 7, 6),
                                      "NCDHW")])
def test_interpolate_mode_matches_the_reference(mode, shape, fmt, size,
                                                corners):
    x = R(shape, 91)
    kw = dict(mode=mode, align_corners=corners, data_format=fmt, **size)
    jx = jp.to_tensor(x, stop_gradient=False)
    jy = jF.interpolate(jx, **kw)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tF.interpolate(tx, **kw)
    want = np.asarray(jy.numpy())
    assert tuple(ty.shape) == want.shape
    np.testing.assert_allclose(ty.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    w = R(want.shape, 92)
    (jy * jp.to_tensor(w)).sum().backward()
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-5)
