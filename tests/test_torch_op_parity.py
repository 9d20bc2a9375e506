"""Helpers of the op-namespace parity tests (``tests/test_torch_{math,
manip,linalg}_ops.py``, ``tests/test_torch_tensor_patch.py``): one case
runs the JAX package's op and the port's on the same seeded numpy
inputs, compares every output's values and dtype, and, for a
differentiable op, the gradients of a weighted sum of the first output
through both packages' ``backward()``.

Dtypes must be equal, with one stated exception a case opts into
(``x64=True``): the JAX package runs without x64, so an int64 result
there is stored as int32 (float64 as float32), where the port's is
int64 (float64).
"""

from __future__ import annotations

import numpy as np
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from test_torch_op_cases import ELEM, LINALG, RED, Case, R, ids, np_of  # noqa: F401

def _tensors(v, mod, grad):
    if isinstance(v, np.ndarray):
        t = mod.to_tensor(v)
        if grad:
            t.stop_gradient = False
        return t
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [_tensors(e, mod, grad) for e in v]
    return v


def port_np(t):
    return t.detach().cpu().numpy() if type(t) is torch.Tensor else \
        np.asarray(t.numpy())


def dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return np.dtype(t.dtype).name


def assert_same(j, t, tol=ELEM, x64=False, what="out"):
    if isinstance(j, (tuple, list)):
        assert isinstance(t, (tuple, list)), f"{what}: {type(t)}"
        assert len(j) == len(t), f"{what}: {len(j)} vs {len(t)} outputs"
        for k, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, tol, x64, f"{what}[{k}]")
        return
    if isinstance(j, jp.Tensor):
        assert isinstance(t, torch.Tensor), f"{what}: {type(t)}"
        jd, td = dtype_name(j), dtype_name(t)
        assert jd == td or (x64 and (jd, td) in (("int32", "int64"),
                                                 ("float32", "float64"))), \
            f"{what}: dtype {td}, the reference's {jd}"
        a, b = np.asarray(j.numpy()), port_np(t)
        assert a.shape == b.shape, f"{what}: shape {b.shape} vs {a.shape}"
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       equal_nan=True, err_msg=what)
        else:
            np.testing.assert_array_equal(b, a, err_msg=what)
        return
    assert j == t, f"{what}: {t!r} vs {j!r}"


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def run(case: Case, jmod, tmod):
    """Run ``case`` through ``jmod``'s and ``tmod``'s op (modules or
    callables taking the op's name)."""
    jf = jmod(case.op) if callable(jmod) and not hasattr(jmod, case.op) \
        else getattr(jmod, case.op)
    tf = tmod(case.op) if callable(tmod) and not hasattr(tmod, case.op) \
        else getattr(tmod, case.op)
    jargs = [_tensors(a, jp, i in case.grad) for i, a in enumerate(case.args)]
    targs = [_tensors(a, tp, i in case.grad) for i, a in
             enumerate(case.args)]
    jo = jf(*jargs, **case.kw)
    to = tf(*targs, **case.kw)
    if case.check is not None:
        case.check(jo, to)
    else:
        assert_same(jo, to, case.tol, case.x64)
    for i in case.after:
        assert_same(jargs[i], targs[i], case.tol, case.x64, f"arg {i}")
    if case.grad:
        j0, t0 = _first(jo), _first(to)
        w = R(tuple(np.asarray(j0.numpy()).shape), 99)
        (j0 * jp.to_tensor(w)).sum().backward()
        (t0 * tp.to_tensor(w)).sum().backward()
        for i in case.grad:
            assert_same(jargs[i].grad, targs[i].grad, case.tol, False,
                        f"grad of arg {i}")
