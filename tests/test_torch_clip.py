"""The port's gradient clips (``paddle1_tpu_torch.nn.clip``) against the JAX
package's on the same gradients, and their use as an optimizer's
``grad_clip``."""

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.core.tensor import Parameter as JParameter
from paddle1_tpu_torch import nn as tnn
from paddle1_tpu_torch.optimizer import Momentum

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(16, 8), (8,), (4, 4, 3)]


def _grads(scale, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _pairs(grads, frozen=()):
    """The same gradients as (param, grad) pairs in both packages; the
    parameters at ``frozen`` have ``need_clip`` False, and one gradient
    is None in both."""
    jp, tp = [], []
    for i, g in enumerate(grads):
        jw = JParameter(np.zeros(g.shape, np.float32))
        tw = torch.nn.Parameter(torch.zeros(g.shape))
        if i in frozen:
            jw.need_clip = False
            tw.need_clip = False
        jp.append((jw, paddle.to_tensor(g)))
        tp.append((tw, torch.from_numpy(g.copy())))
    jp.append((JParameter(np.zeros(2, np.float32)), None))
    tp.append((torch.nn.Parameter(torch.zeros(2)), None))
    return jp, tp


def _check(jout, tout):
    assert len(jout) == len(tout)
    for (_, jg), (_, tg) in zip(jout, tout):
        if jg is None:
            assert tg is None
            continue
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg.numpy()), **TOL)


CLIPS = [("ClipGradByValue", (0.5,), {}),
         ("ClipGradByValue", (0.5,), dict(min=-0.1)),
         ("ClipGradByNorm", (1.0,), {}),
         ("ClipGradByNorm", (100.0,), {}),          # no gradient clipped
         ("ClipGradByGlobalNorm", (1.0,), {}),
         ("ClipGradByGlobalNorm", (1e3,), {})]     # scale 1


@pytest.mark.parametrize("name,args,kw", CLIPS)
@pytest.mark.parametrize("frozen", [(), (1,)])
def test_clip_class_matches_jax(name, args, kw, frozen):
    grads = _grads(2.0)
    jp, tp = _pairs(grads, frozen)
    jout = getattr(paddle.nn, name)(*args, **kw)(jp)
    tout = getattr(tnn, name)(*args, **kw)(tp)
    _check(jout, tout)
    for i in frozen:          # need_clip=False passes through untouched
        assert tout[i][1] is tp[i][1]


def test_global_norm_clip_really_clips():
    grads = _grads(2.0)
    _, tp = _pairs(grads)
    out = tnn.ClipGradByGlobalNorm(1.0)(tp)
    total = np.sqrt(sum(float((g.numpy().astype(np.float64) ** 2).sum())
                        for _, g in out if g is not None))
    assert total == pytest.approx(1.0, rel=1e-5)
    assert np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in grads)) > 10.0


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    grads = _grads(3.0, seed=1)
    jps, tps = [], []
    for g in grads:
        jw = JParameter(np.zeros(g.shape, np.float32))
        jw.grad = paddle.to_tensor(g)
        tw = torch.nn.Parameter(torch.zeros(g.shape))
        tw.grad = torch.from_numpy(g.copy())
        jps.append(jw)
        tps.append(tw)
    jtotal = paddle.nn.clip_grad_norm_(jps, max_norm, norm_type)
    ttotal = tnn.clip_grad_norm_(tps, max_norm, norm_type)
    np.testing.assert_allclose(float(ttotal), float(np.asarray(
        jtotal.numpy())), rtol=1e-6)
    for jw, tw in zip(jps, tps):
        np.testing.assert_allclose(tw.grad.numpy(),
                                   np.asarray(jw.grad.numpy()), **TOL)


def test_clip_grad_value_matches_jax():
    grads = _grads(3.0, seed=2)
    jps, tps = [], []
    for g in grads:
        jw = JParameter(np.zeros(g.shape, np.float32))
        jw.grad = paddle.to_tensor(g)
        tw = torch.nn.Parameter(torch.zeros(g.shape))
        tw.grad = torch.from_numpy(g.copy())
        jps.append(jw)
        tps.append(tw)
    paddle.nn.clip_grad_value_(jps, 0.7)
    tnn.clip_grad_value_(tps, 0.7)
    for jw, tw in zip(jps, tps):
        np.testing.assert_allclose(tw.grad.numpy(),
                                   np.asarray(jw.grad.numpy()), **TOL)
    assert max(float(tw.grad.abs().max()) for tw in tps) == pytest.approx(0.7)


def test_single_tensor_and_no_grads():
    w = torch.nn.Parameter(torch.zeros(3))
    assert float(tnn.clip_grad_norm_(w, 1.0)) == 0.0
    w.grad = torch.full((3,), 4.0)
    total = tnn.clip_grad_norm_(w, 1.0)
    assert float(total) == pytest.approx(np.sqrt(48.0))
    np.testing.assert_allclose(w.grad.numpy(), np.full(3, 1 / np.sqrt(3)),
                               rtol=1e-5)


@pytest.mark.parametrize("name,args", [("ClipGradByGlobalNorm", (0.5,)),
                                       ("ClipGradByNorm", (0.5,)),
                                       ("ClipGradByValue", (0.05,))])
def test_optimizer_grad_clip_matches_jax_eager_step(name, args):
    # the eager optimizer step clips before the update in both packages
    # (Momentum: the update is linear in the gradient, so the clip shows)
    grads = _grads(2.0, seed=3)
    rng = np.random.default_rng(4)
    w0 = [rng.standard_normal(g.shape).astype(np.float32) for g in grads]
    jps = [paddle.create_parameter(list(w.shape), "float32") for w in w0]
    for jw, w in zip(jps, w0):
        jw.set_value(w)
    jopt = paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jps,
        grad_clip=getattr(paddle.nn, name)(*args))
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    topt = Momentum(learning_rate=0.1, momentum=0.9, parameters=tps,
                    grad_clip=getattr(tnn, name)(*args))
    for _ in range(2):
        for jw, tw, g in zip(jps, tps, grads):
            jw.grad = paddle.to_tensor(g)
            tw.grad = torch.from_numpy(g.copy())
        jopt.step()
        topt.step()
    for jw, tw in zip(jps, tps):
        np.testing.assert_allclose(tw.detach().numpy(),
                                   np.asarray(jw.numpy()), **TOL)
    moved = max(float((tw.detach() - torch.from_numpy(w)).abs().max())
                for tw, w in zip(tps, w0))
    unclipped = 0.1 * 2.9 * max(float(np.abs(g).max()) for g in grads)
    assert moved < 0.5 * unclipped
