"""float16 on rows 8-12 (the batch-norm training forward, the
given-statistics forward, the local moments and both backward passes)
against the JAX package's Pallas kernels in interpret mode on the CPU, on
float16 row tensors with float16 or float32 affine parameters, as
``ParallelEngine(amp_dtype="float16")`` hands them (F24).

The port's plain versions (which its CPU tensors run, and which the card
holds its kernels to) compute every sum, product and the normalization in
f32 and round once at the edge, as the Pallas bodies do. Tolerances: a
stored f16 value may differ by one f16 rounding step at its magnitude
(2^-10 relative: both sides round their own f32 result) on top of the f32
tolerance of the same comparison in ``tests/test_torch_conv.py`` (1e-5);
the statistics and the gamma/beta gradients are f32 in both (1e-5, and
1e-4 relative for the gradients' sums of f16-rounded products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.ops.pallas import fused_bn as jbn
from paddle1_tpu_torch.ops import fused_bn as tbn

KERNELS = dict(conv_nhwc="always", fused_bn="always", fused_bn_bwd="always")
F16_REL, ABS = 2.0 ** -10, 1e-5
STAT = dict(atol=1e-5, rtol=1e-5)
GRAD_SUM = dict(atol=1e-4, rtol=1e-4)
ACT_RES = [(a, r) for a in ("identity", "relu") for r in (False, True)]


def _case(seed, pdtype, rows=128, c=16):
    rng = np.random.default_rng(seed)
    f16 = lambda a: a.astype(np.float16)   # noqa: E731
    x = f16(rng.standard_normal((rows, c)) * 1.5 + 0.3)
    g = rng.standard_normal(c).astype(pdtype)
    b = rng.standard_normal(c).astype(pdtype)
    res = f16(rng.standard_normal((rows, c)))
    m = rng.standard_normal(c).astype(np.float32) * 0.2
    v = rng.uniform(0.5, 2.0, c).astype(np.float32)
    dy = f16(rng.standard_normal((rows, c)))
    return x, g, b, res, m, v, dy


def _close_f16(got, want, name):
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    excess = np.abs(got - want) - F16_REL * np.abs(want)
    assert float(excess.max()) <= ABS, (name, float(excess.max()))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


PDTYPES = [np.float16, np.float32]


@pytest.mark.parametrize("pdtype", PDTYPES, ids=["f16-params",
                                                 "f32-params"])
@pytest.mark.parametrize("act,use_res", ACT_RES)
def test_f16_train_forward_and_backward_match_the_pallas_kernels(
        pdtype, act, use_res):
    x, g, b, res, _, _, dy = _case(1, pdtype)
    r = res if use_res else None
    with jax_flags_guard(**KERNELS):
        def f(x_, g_, b_, r_):
            return jbn.fused_bn_train(x_, g_, b_, 1e-5, act, r_)
        (jy, jm, jv), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b),
                                    None if r is None else jnp.asarray(r))
        zeros = jnp.zeros(x.shape[1], jnp.float32)
        jgrads = vjp((jnp.asarray(dy), zeros, zeros))
    ins = [_t(a).requires_grad_() for a in (x, g, b)]
    tr = None if r is None else _t(r).requires_grad_()
    ty, tm, tv = tbn.fused_bn_train(*ins, 1e-5, act, residual=tr)
    assert ty.dtype == torch.float16
    assert tm.dtype == tv.dtype == torch.float32
    _close_f16(ty, jy, "y")
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm), **STAT)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **STAT)
    tgrads = torch.autograd.grad(ty, ins + ([tr] if tr is not None else []),
                                 _t(dy))
    names = ("dx", "dg", "db", "dres")
    for got, want, name in zip(tgrads, jgrads, names):
        assert got.dtype == torch.from_numpy(np.zeros(1, np.asarray(
            want).dtype)).dtype, name
        if name in ("dg", "db") and pdtype == np.float32:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=name, **GRAD_SUM)
        else:
            _close_f16(got, want, name)


@pytest.mark.parametrize("pdtype", PDTYPES, ids=["f16-params",
                                                 "f32-params"])
@pytest.mark.parametrize("act,use_res", ACT_RES)
def test_f16_norm_forward_and_backward_match_the_pallas_kernels(
        pdtype, act, use_res):
    x, g, b, res, m, v, dy = _case(2, pdtype)
    r = res if use_res else None
    with jax_flags_guard(**KERNELS):
        def f(x_, g_, b_, r_):
            return jbn.fused_bn_norm(x_, jnp.asarray(m), jnp.asarray(v), g_,
                                     b_, 1e-5, act, r_)
        jy, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          None if r is None else jnp.asarray(r))
        jgrads = vjp(jnp.asarray(dy))
    ins = [_t(a).requires_grad_() for a in (x, g, b)]
    tr = None if r is None else _t(r).requires_grad_()
    ty = tbn.fused_bn_norm(ins[0], _t(m), _t(v), ins[1], ins[2], 1e-5, act,
                           residual=tr)
    assert ty.dtype == torch.float16
    _close_f16(ty, jy, "y")
    tgrads = torch.autograd.grad(ty, ins + ([tr] if tr is not None else []),
                                 _t(dy))
    for got, want, name in zip(tgrads, jgrads, ("dx", "dg", "db", "dres")):
        if name in ("dg", "db") and pdtype == np.float32:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=name, **GRAD_SUM)
        else:
            _close_f16(got, want, name)


def test_f16_local_moments_match_the_pallas_kernel():
    x = _case(3, np.float16, rows=200, c=24)[0]
    with jax_flags_guard(**KERNELS):
        js, jss = jbn.local_moments(jnp.asarray(x))
    s, ss = tbn.local_moments(_t(x))
    assert s.dtype == ss.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **STAT)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5,
                               atol=1e-4)


def test_f16_is_inside_the_batch_norm_contract_and_f64_is_not():
    assert tbn.supported((4, 16), torch.float16)
    assert tbn.supported((4, 16), torch.bfloat16)
    assert not tbn.supported((4, 16), torch.float64)
