"""float16 on rows 3-6 (the flash forward, its dK/dV and dQ passes, fused
Adam) against the JAX package's Pallas kernels in interpret mode on the
CPU, on float16 inputs.

``auto_cast(dtype="float16")`` hands the flash kernels float16 q, k and
v, and ``decorate(level="O2", dtype="float16")`` hands fused Adam float16
parameters. The port's plain versions (which its CPU tensors run, and
which the card holds its kernels to) and the CPU emulations of the
tensor-core kernels' arithmetic in float16 are held here to the JAX
package's kernels run on the same float16 inputs.

Tolerances: both sides compute in f32 and round the result to f16 at the
edge, so a stored value may differ by one f16 rounding step at its
magnitude (``2^-11 max|want|``) on top of the f32 tolerance of the same
comparison in ``tests/test_torch_train.py`` (2e-5 forward, 1e-4 backward,
the emulations' 1e-4); LSE is f32 in both (2e-5). fused Adam: the moments
are f32 (the JAX package's 1e-6 / 1e-7), the parameter one f16 step.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle1_tpu.ops.pallas import flash_attention as jfa
from paddle1_tpu.ops.pallas import fused_adam as jadam
from paddle1_tpu.ops.pallas.flash_attention_bwd import \
    flash_attention_bwd as j_flash_bwd
from paddle1_tpu_torch.ops import flash_attention as tfa
from paddle1_tpu_torch.ops import flash_attention_bwd as tfb
from paddle1_tpu_torch.ops import fused_adam as tadam

F16_STEP = 2.0 ** -11
FWD_ABS, BWD_ABS, LSE_TOL = 2e-5, 1e-4, dict(atol=2e-5, rtol=2e-5)
CASES = [  # nq, nk, heads, dim, causal
    (128, 128, 2, 32, False),
    (128, 128, 2, 64, True),
    (128, 256, 2, 64, True),    # bottom-right causal, nq < nk
    (128, 256, 2, 128, False),  # ERNIE's D = 128
]


def _case(seed, nq, nk, h, d):
    """float16 q, k, v, dout, a [B, Nk] keep-mask with a padded tail and a
    fully padded batch row."""
    rng = np.random.default_rng(seed)
    arr = lambda n: rng.standard_normal((2, n, h, d)).astype(  # noqa: E731
        np.float16)
    pm = np.ones((2, nk), np.float32)
    pm[0, nk // 2 + 5:] = 0.0
    pm[1] = 0.0
    return arr(nq), arr(nk), arr(nk), pm, arr(nq)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close16(got, want, abs_tol, what):
    want = np.asarray(want).astype(np.float32)
    got = np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=abs_tol + F16_STEP * np.abs(want).max())


def _pallas(q, k, v, pm, dout, scale, causal):
    jq, jk, jv, jpm = (jnp.asarray(a) for a in (q, k, v, pm))
    out, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, padding_mask=jpm)
    grads = j_flash_bwd(jq, jk, jv, out, lse, jnp.asarray(dout), scale,
                        causal, padding_mask=jpm)
    return out, lse, grads


@pytest.mark.parametrize("nq,nk,h,d,causal", CASES)
def test_flash_plain_versions_in_float16_match_pallas(nq, nk, h, d, causal):
    """The plain forward and backward on float16 tensors return float16
    (LSE float32) within one f16 step of the Pallas kernels' on the same
    float16 inputs; the fully padded row gives 0 and the sentinel."""
    q, k, v, pm, dout = _case(nq + d, nq, nk, h, d)
    scale = 1.0 / math.sqrt(d)
    out, lse, grads = _pallas(q, k, v, pm, dout, scale, causal)
    assert out.dtype == jnp.float16 and lse.dtype == jnp.float32
    keep = _t(pm) > 0.5
    got_o, got_l = tfa.flash_attention_ref(_t(q), _t(k), _t(v), scale,
                                           causal, keep)
    assert got_o.dtype == torch.float16 and got_l.dtype == torch.float32
    _close16(got_o.float(), out, FWD_ABS, "out")
    np.testing.assert_array_equal(got_o.float().numpy()[1], 0.0)
    live = np.asarray(lse) > -1e29
    np.testing.assert_array_equal(got_l.numpy() > -1e29, live)
    np.testing.assert_allclose(got_l.numpy()[live], np.asarray(lse)[live],
                               **LSE_TOL)
    got = tfa.flash_bwd_ref(_t(q), _t(k), _t(v), _t(np.asarray(out)),
                            _t(np.asarray(lse)), _t(dout), scale, causal,
                            keep)
    for g, w, name in zip(got, grads, ("dq", "dk", "dv")):
        assert g.dtype == torch.float16 and w.dtype == jnp.float16
        _close16(g.float(), w, BWD_ABS, name)
        np.testing.assert_array_equal(g.float().numpy()[1], 0.0)


@pytest.mark.parametrize("nq,nk,h,d,causal", CASES)
def test_tensor_core_emulations_in_float16_match_pallas(nq, nk, h, d,
                                                        causal):
    """The tensor-core kernels' arithmetic in float16 (operands as f16,
    P and dS split into f16 hi + lo, f32 sums): forward, dK/dV and dQ
    within the emulations' 1e-4 and one f16 step of the Pallas kernels'
    on the same float16 inputs."""
    q, k, v, pm, dout = _case(5 * nq + d, nq, nk, h, d)
    scale = 1.0 / math.sqrt(d)
    out, lse, (dq, dk, dv) = _pallas(q, k, v, pm, dout, scale, causal)
    keep = _t(pm) > 0.5
    f16 = torch.float16
    got_o, got_l = tfa.flash_fwd_tc_emulation(_t(q), _t(k), _t(v), scale,
                                              causal, keep, dtype=f16)
    _close16(got_o.to(f16).float(), out, BWD_ABS, "out")
    live = np.asarray(lse) > -1e29
    np.testing.assert_allclose(got_l.numpy()[live], np.asarray(lse)[live],
                               **LSE_TOL)
    delta = (dout.astype(np.float32) *
             np.asarray(out).astype(np.float32)).sum(-1).transpose(0, 2, 1)
    args = (_t(q), _t(k), _t(v), _t(dout), _t(np.asarray(lse)), _t(delta),
            scale, causal, keep)
    got_k, got_v = tfb.flash_bwd_dkv_tc_emulation(*args, dtype=f16)
    got_q = tfb.flash_bwd_dq_tc_emulation(*args, dtype=f16)
    for g, w, name in ((got_q, dq, "dq"), (got_k, dk, "dk"),
                       (got_v, dv, "dv")):
        _close16(g.to(f16).float(), w, BWD_ABS, name)
        np.testing.assert_array_equal(g.numpy()[1], 0.0)


def test_float16_is_in_the_flash_kernels_contract():
    """float16 has the kernels' dtype code; the CPU wrapper runs the plain
    version in float16."""
    assert tfa._DTYPES[torch.float16] == 2
    assert tadam._DTYPES[torch.float16] == 2
    q, k, v, pm, _ = _case(3, 128, 128, 2, 32)
    out = tfa.flash_attention(_t(q), _t(k), _t(v),
                              padding_mask=_t(pm) > 0.5)
    assert out.dtype == torch.float16


@pytest.mark.parametrize("n,step,decay", [(8192 + 123, 3, 0.01),
                                          (3 * 8192, 1, 0.0)])
def test_fused_adam_plain_version_in_float16_matches_pallas(n, step, decay):
    """float16 parameters and gradients with f32 moments: the plain version
    against the Pallas kernel on the same float16 inputs."""
    rng = np.random.default_rng(n)
    p = rng.standard_normal(n).astype(np.float16)
    g = rng.standard_normal(n).astype(np.float16)
    m1 = (rng.standard_normal(n) * 0.01).astype(np.float32)
    m2 = np.abs(rng.standard_normal(n) * 0.01).astype(np.float32)
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    want = jadam.fused_adam_update(jnp.asarray(p), jnp.asarray(g),
                                   jnp.asarray(m1), jnp.asarray(m2), lr,
                                   jnp.asarray(step, jnp.int32), b1, b2,
                                   eps, decay)
    st = torch.tensor(float(step))
    bc1, bc2 = 1.0 - torch.pow(b1, st), 1.0 - torch.pow(b2, st)
    got = tadam.fused_adam_ref(_t(p), _t(g), _t(m1), _t(m2),
                               torch.tensor(lr), bc1, bc2, decay, b1, b2, eps)
    assert got[0].dtype == torch.float16 and want[0].dtype == jnp.float16
    _close16(got[0].float(), want[0], 0.0, "p")
    for a, b, name in zip(got[1:], want[1:], ("m1", "m2")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
