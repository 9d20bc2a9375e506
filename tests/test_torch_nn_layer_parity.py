"""The nn slice's layers against the JAX package on the CPU: every
``LayerCase`` of ``tests/test_torch_nn_cases.py`` (each layer of
``nn/layer_norm_act.py`` and ``nn/layer_loss.py`` but the containers) built
in both packages, its parameters and buffers the JAX package's carried
across by ``convert.state_from_jax`` (``SpectralNorm``'s ``weight_u``/
``weight_v``, ``HSigmoidLoss``'s random weight), then called on the same
seeded numpy inputs: values and dtypes, the gradients of a weighted sum of
the output with respect to the listed inputs and every parameter, and the
buffers after the call (running statistics). Tolerances are each case's
(``ELEM`` 1e-6, ``RED`` 1e-5, ``LINALG`` 1e-4, f32).
"""

import numpy as np
import pytest

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax

from test_torch_nn_cases import LayerCase, layer_cases
from test_torch_op_cases import R, ids
from test_torch_op_parity import _tensors, assert_same, port_np


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


LAYERS = layer_cases()


def _layer(pkg, case):
    def t(v):
        return pkg.to_tensor(v) if isinstance(v, np.ndarray) else v
    layer = getattr(pkg.nn, case.op)(*[t(a) for a in case.ctor],
                                     **{k: t(v) for k, v in
                                        case.ctor_kw.items()})
    layer.train() if case.train else layer.eval()
    return layer


def _state(layer, jax_side):
    return {k: (np.asarray(v.numpy()) if jax_side else port_np(v))
            for k, v in layer.state_dict().items()}


@pytest.mark.parametrize("case", LAYERS, ids=ids(LAYERS))
def test_layer_matches_the_reference(case: LayerCase):
    jl = _layer(jp, case)
    with tp.utils.unique_name.guard():
        tl = _layer(tp, case)
    tl.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jl.functional_state().items()}, tl))
    jargs = [_tensors(a, jp, i in case.grad) for i, a in
             enumerate(case.args)]
    targs = [_tensors(a, tp, i in case.grad) for i, a in
             enumerate(case.args)]
    jkw = {k: _tensors(v, jp, False) for k, v in case.kw.items()}
    tkw = {k: _tensors(v, tp, False) for k, v in case.kw.items()}
    jo, to = jl(*jargs, **jkw), tl(*targs, **tkw)
    assert_same(jo, to, case.tol)
    w = R(tuple(np.asarray(jo.numpy()).shape), 99)
    (jo * jp.to_tensor(w)).sum().backward()
    (to * tp.to_tensor(w)).sum().backward()
    for i in case.grad:
        assert_same(jargs[i].grad, targs[i].grad, case.tol, what=f"grad {i}")
    jparams = dict(jl.named_parameters())
    tparams = dict(tl.named_parameters())
    assert sorted(jparams) == sorted(tparams)
    for name, jparam in jparams.items():
        jg, tg = jparam.grad, tparams[name].grad
        assert (jg is None) == (tg is None), name
        if jg is not None:
            assert_same(jg, tg, case.tol, what=f"grad of {name}")
    # the running statistics after a training forward
    js, ts = _state(jl, True), _state(tl, False)
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=case.tol,
                                   atol=case.tol, err_msg=k)


def test_layer_state_dicts_carry_the_jax_package_s_weights():
    """PReLU's weight, SpectralNorm's weight_u/weight_v, GroupNorm's and
    InstanceNorm's affine load from the JAX package's state under the same
    names and shapes."""
    for make in (lambda nn: nn.PReLU(4, 0.3),
                 lambda nn: nn.SpectralNorm([4, 6]),
                 lambda nn: nn.GroupNorm(2, 6),
                 lambda nn: nn.InstanceNorm2D(6),
                 lambda nn: nn.HSigmoidLoss(5, 6)):
        jl = make(jp.nn)
        with tp.utils.unique_name.guard():
            tl = make(tp.nn)
        state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
        assert state, type(jl).__name__
        tl.load_state_dict(state_from_jax(state, tl))
        for k, v in tl.state_dict().items():
            np.testing.assert_array_equal(port_np(v), state[k])
