"""The conv-net slice of the PyTorch port (ResNet training and eval on
the fused batch-norm kernels) against the JAX package, on the CPU.

Inputs and weights come from numpy with a seed and go through both
packages; weights cross through ``paddle1_tpu_torch.convert``. The JAX
side runs its fused batch-norm Pallas kernels in interpret mode under
``flags_guard(conv_nhwc="always", fused_bn="always",
fused_bn_bwd="always")``, as its own tests do; the port's wrappers run
their plain versions on CPU tensors (the CUDA kernels are held to those
on the card by ``chip_smoke.py``). Each arm of the port is held to the
same arm of the JAX package. Everything is float32; each tolerance is
stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.core.tensor import Tensor, to_tensor
from paddle1_tpu.nn import functional as jF
from paddle1_tpu.ops.pallas import fused_bn as jbn
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.distributed import ParallelEngine
from paddle1_tpu_torch.nn import functional as tF
from paddle1_tpu_torch.ops import fused_bn as tbn
from paddle1_tpu_torch.ops import fused_bn_bwd as tbb
from paddle1_tpu_torch.optimizer import Momentum

KERNELS = dict(conv_nhwc="always", fused_bn="always", fused_bn_bwd="always")
PLAIN = dict(conv_nhwc="never", fused_bn="never", fused_bn_bwd="never")
# one BN: both sides sum 64-128 rows per channel in f32 in other orders,
# and dx chains two such sums; 1e-5 covers that at these sizes
BN_TOL = dict(atol=1e-5, rtol=1e-5)
# convolutions: cuDNN-free CPU convs on both sides, other summation
# orders over up to 7 * 7 * 3 products
CONV_TOL = dict(atol=1e-5, rtol=1e-5)
# whole models and engine steps: the same sums, compounded through the
# layers and three optimizer steps
MOD_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(t):
    return np.asarray(t.numpy())


def _bn_case(seed, rows=128, c=16):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, c)) * 1.5 + 0.3).astype(np.float32)
    g = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    res = rng.standard_normal((rows, c)).astype(np.float32)
    m = rng.standard_normal(c).astype(np.float32) * 0.2
    v = rng.uniform(0.5, 2.0, c).astype(np.float32)
    dy = rng.standard_normal((rows, c)).astype(np.float32)
    dm = rng.standard_normal(c).astype(np.float32)
    dv = rng.standard_normal(c).astype(np.float32)
    return x, g, b, res, m, v, dy, dm, dv


ACT_RES = [(a, r) for a in ("identity", "relu") for r in (False, True)]


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (forward, stats, VJP)


@pytest.mark.parametrize("act,use_res", ACT_RES)
def test_train_ref_and_its_grads_match_the_pallas_kernels(act, use_res):
    x, g, b, res, _, _, dy, dm, dv = _bn_case(1)
    r = res if use_res else None
    with jax_flags_guard(**KERNELS):
        def f(x_, g_, b_, r_):
            return jbn.fused_bn_train(x_, g_, b_, 1e-5, act,
                                      None if r_ is None else r_)
        (jy, jm, jv), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b),
                                    None if r is None else jnp.asarray(r))
        jgrads = vjp((jnp.asarray(dy), jnp.asarray(dm), jnp.asarray(dv)))
    ins = [_t(a).requires_grad_() for a in (x, g, b)]
    tr = None if r is None else _t(r).requires_grad_()
    ty, tm, tv = tbn.fused_bn_train(*ins, 1e-5, act, residual=tr)
    assert tm.dtype == tv.dtype == torch.float32
    tgrads = torch.autograd.grad((ty, tm, tv), ins + ([tr] if tr is not None
                                                      else []),
                                 (_t(dy), _t(dm), _t(dv)))
    for got, want, name in zip((ty, tm, tv) + tuple(tgrads),
                               (jy, jm, jv) + tuple(jgrads),
                               ("y", "mean", "var", "dx", "dg", "db",
                                "dres")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=name, **BN_TOL)


@pytest.mark.parametrize("act,use_res", ACT_RES)
def test_norm_ref_and_its_grads_match_the_pallas_kernels(act, use_res):
    x, g, b, res, m, v, dy, _, _ = _bn_case(2)
    r = res if use_res else None
    with jax_flags_guard(**KERNELS):
        def f(x_, m_, v_, g_, b_, r_):
            return jbn.fused_bn_norm(x_, m_, v_, g_, b_, 1e-5, act, r_)
        jy, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, m, v, g, b)),
                          None if r is None else jnp.asarray(r))
        jgrads = vjp(jnp.asarray(dy))
    ins = [_t(a).requires_grad_() for a in (x, m, v, g, b)]
    tr = None if r is None else _t(r).requires_grad_()
    ty = tbn.fused_bn_norm(*ins, 1e-5, act, residual=tr)
    tgrads = torch.autograd.grad(ty, ins + ([tr] if tr is not None else []),
                                 _t(dy))
    for got, want, name in zip((ty,) + tuple(tgrads), (jy,) + tuple(jgrads),
                               ("y", "dx", "dmean", "dvar", "dg", "db",
                                "dres")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=name, **BN_TOL)


@pytest.mark.parametrize("which", ["train", "norm"])
def test_backward_flag_never_takes_the_plain_backward(monkeypatch, which):
    x, g, b, _, m, v, dy, _, _ = _bn_case(3)
    seen = []
    for name in ("train_bwd_ref", "norm_bwd_ref"):
        orig = getattr(tbb, name)
        monkeypatch.setattr(tbb, name, lambda *a, _o=orig, _n=name, **k: (
            seen.append(_n), _o(*a, **k))[1])
    ins = [_t(a).requires_grad_() for a in (x, g, b)]
    with tflags.flags_guard(fused_bn_bwd="never"):
        if which == "train":
            y = tbn.fused_bn_train(*ins, 1e-5)[0]
        else:
            y = tbn.fused_bn_norm(ins[0], _t(m), _t(v), ins[1], ins[2],
                                  1e-5)
        torch.autograd.grad(y, ins, _t(dy))
    assert seen == [f"{which}_bwd_ref"]


def test_supported_and_act_contract():
    assert tbn.supported((4, 16)) and tbn.supported((2, 3, 5, 8),
                                                    torch.bfloat16)
    assert not tbn.supported((16,)) and not tbn.supported((4, 12))
    assert not tbn.supported((4, 16), torch.float64)
    assert not tbn.supported((0, 16))
    from paddle1_tpu_torch.core.errors import InvalidArgumentError
    with pytest.raises(InvalidArgumentError, match="activation"):
        tbn.fused_bn_train(torch.zeros(4, 8), torch.ones(8),
                           torch.zeros(8), 1e-5, act="gelu")


# ---------------------------------------------------------------------------
# the functionals: batch_norm / fused_batch_norm_act, both arms


def _functional_run(side, flags, training, use_global_stats, act, use_res,
                    seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 16, 4, 4)) * 2 + 0.5).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    m0 = rng.standard_normal(16).astype(np.float32) * 0.1
    v0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    kw = dict(training=training, momentum=0.8,
              use_global_stats=use_global_stats)
    fused = act != "identity" or use_res
    if side == "jax":
        m, v = to_tensor(m0.copy()), to_tensor(v0.copy())
        with jax_flags_guard(**flags):
            args = (to_tensor(x), m, v, to_tensor(g), to_tensor(b))
            if fused:
                y = jF.fused_batch_norm_act(
                    *args, act=act,
                    residual=to_tensor(res) if use_res else None, **kw)
            else:
                y = jF.batch_norm(*args, **kw)
        return _np(y), _np(m), _np(v)
    m, v = _t(m0), _t(v0)
    with tflags.flags_guard(**flags):
        args = (_t(x), m, v, _t(g), _t(b))
        if fused:
            y = tF.fused_batch_norm_act(
                *args, act=act, residual=_t(res) if use_res else None, **kw)
        else:
            y = tF.batch_norm(*args, **kw)
    assert tuple(y.shape) == x.shape
    return y.numpy(), m.numpy(), v.numpy()


@pytest.mark.parametrize("flags", [KERNELS, PLAIN], ids=["kernel", "plain"])
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
@pytest.mark.parametrize("act,use_res", [("identity", False),
                                         ("relu", True)])
def test_batch_norm_functionals_match_jax(flags, mode, act, use_res):
    training = mode != "eval"
    ugs = True if mode == "global_stats" else None
    want = _functional_run("jax", flags, training, ugs, act, use_res)
    got = _functional_run("torch", flags, training, ugs, act, use_res)
    for a, b, name in zip(got, want, ("y", "running_mean", "running_var")):
        np.testing.assert_allclose(a, b, err_msg=name, **BN_TOL)
    if mode != "train":     # given statistics leave the buffers alone
        np.testing.assert_array_equal(got[1], _functional_run(
            "torch", flags, False, None, act, use_res)[1])


def test_running_stats_follow_paddles_momentum_and_biased_variance():
    x = torch.randn(8, 16, 3, 3)
    m, v = torch.zeros(16), torch.ones(16)
    tF.batch_norm(x, m, v, torch.ones(16), torch.zeros(16), training=True,
                  momentum=0.9)
    bm = x.mean(dim=(0, 2, 3))
    bv = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(m, 0.1 * bm, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(v, 0.9 + 0.1 * bv, atol=1e-6, rtol=1e-5)


def test_kernel_path_reads_a_free_channels_last_view(monkeypatch):
    seen = []
    orig = tbn._train_fwd
    monkeypatch.setattr(tbn, "_train_fwd", lambda x2, *a: (
        seen.append(x2._base is not None and x2.is_contiguous()),
        orig(x2, *a))[1])
    x = torch.randn(2, 16, 5, 5).contiguous(memory_format=torch.channels_last)
    with tflags.flags_guard(**KERNELS):
        y = tF.batch_norm(x, torch.zeros(16), torch.ones(16),
                          torch.ones(16), torch.zeros(16), training=True)
    assert seen == [True]       # a view of x's storage, no copy
    assert y.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# conv and pooling layers


@pytest.mark.parametrize("cfg", [
    dict(cin=3, cout=8, k=7, stride=2, padding=3, bias=False),
    dict(cin=8, cout=16, k=3, stride=2, padding=1, bias=True),
    dict(cin=8, cout=8, k=3, stride=1, padding=1, groups=2, bias=False),
    dict(cin=8, cout=16, k=1, stride=1, padding=0, bias=False),
    dict(cin=4, cout=8, k=3, stride=2, padding="SAME", bias=True),
    dict(cin=4, cout=8, k=3, stride=1, padding=[0, 1, 1, 2], bias=True),
    dict(cin=4, cout=8, k=3, stride=1, padding=1, bias=True,
         data_format="NHWC"),
])
@pytest.mark.parametrize("flags", [KERNELS, PLAIN], ids=["nhwc", "nchw"])
def test_conv2d_matches_jax(cfg, flags):
    from paddle1_tpu.nn import Conv2D as JConv
    from paddle1_tpu_torch.nn import Conv2D as TConv
    cfg = dict(cfg)
    bias = cfg.pop("bias")
    fmt = cfg.pop("data_format", "NCHW")
    kw = dict(stride=cfg["stride"], padding=cfg["padding"],
              groups=cfg.get("groups", 1), data_format=fmt,
              bias_attr=None if bias else False)
    paddle.seed(5)
    jc = JConv(cfg["cin"], cfg["cout"], cfg["k"], **kw)
    tc = TConv(cfg["cin"], cfg["cout"], cfg["k"], device="cpu", **kw)
    tc.load_state_dict(state_from_jax(
        {k: np.asarray(a) for k, a in jc.functional_state().items()}, tc))
    shape = (2, cfg["cin"], 11, 11) if fmt == "NCHW" else (2, 11, 11,
                                                           cfg["cin"])
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    with jax_flags_guard(**flags):
        want = _np(jc(to_tensor(x)))
    with tflags.flags_guard(**flags):
        got = tc(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **CONV_TOL)


@pytest.mark.parametrize("kind,kw", [
    ("max", dict(kernel_size=3, stride=2, padding=1)),
    ("max", dict(kernel_size=2)),
    ("max", dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("adaptive", dict(output_size=(1, 1))),
    ("adaptive", dict(output_size=3)),
    ("adaptive", dict(output_size=(2, 3))),
])
@pytest.mark.parametrize("flags", [KERNELS, PLAIN], ids=["nhwc", "nchw"])
def test_pooling_matches_jax(kind, kw, flags):
    from paddle1_tpu.nn import AdaptiveAvgPool2D as JA
    from paddle1_tpu.nn import MaxPool2D as JM
    from paddle1_tpu_torch.nn import AdaptiveAvgPool2D as TA
    from paddle1_tpu_torch.nn import MaxPool2D as TM
    jl, tl = (JM(**kw), TM(**kw)) if kind == "max" else (JA(**kw), TA(**kw))
    x = np.random.default_rng(7).standard_normal((2, 8, 7, 7)).astype(
        np.float32)
    with jax_flags_guard(**flags):
        want = _np(jl(to_tensor(x)))
    with tflags.flags_guard(**flags):
        got = tl(_t(x))
    np.testing.assert_allclose(got.numpy(), want, **CONV_TOL)


# ---------------------------------------------------------------------------
# Momentum


@pytest.mark.parametrize("kw", [dict(), dict(use_nesterov=True),
                                dict(weight_decay=0.01)],
                         ids=["plain", "nesterov", "l2"])
def test_momentum_matches_jax_functional_update(kw):
    rng = np.random.default_rng(8)
    shapes = [(7, 5), (5,), (3, 3, 2)]
    p0 = {f"p{i}": rng.standard_normal(s).astype(np.float32)
          for i, s in enumerate(shapes)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    jopt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9, **kw)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jopt.functional_init(params)
    for g in grads:
        params, state = jopt.functional_update(
            params, {k: jnp.asarray(v) for k, v in g.items()}, state, 0.05)
    tp = [torch.nn.Parameter(_t(v)) for v in p0.values()]
    topt = Momentum(learning_rate=0.05, momentum=0.9, parameters=tp, **kw)
    for g in grads:
        for p, k in zip(tp, p0):
            p.grad = _t(g[k])
        topt.step()
    for p, k in zip(tp, p0):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(params[k]), atol=1e-6,
                                   rtol=1e-6)
    assert set(topt.state_dict()) == {"step", "param_0__velocity",
                                      "param_1__velocity",
                                      "param_2__velocity"}


# ---------------------------------------------------------------------------
# ResNet: state, a bottleneck stack, engine steps


def _jax_state(layer):
    return {k: np.asarray(v) for k, v in layer.functional_state().items()}


@pytest.fixture(scope="module")
def r18_pair():
    from paddle1_tpu.vision.models import resnet18 as jr18
    paddle.seed(9)
    jm = jr18(num_classes=10)
    # running statistics away from their init, so loading them shows
    rng = np.random.default_rng(9)
    state = _jax_state(jm)
    for k in state:
        if k.endswith("_mean"):
            state[k] = rng.standard_normal(state[k].shape).astype(
                np.float32) * 0.1
        elif k.endswith("_variance"):
            state[k] = rng.uniform(0.5, 1.5, state[k].shape).astype(
                np.float32)
    jm.set_state_dict({k: to_tensor(v) for k, v in state.items()})
    return jm, state


def _r18(state):
    from paddle1_tpu_torch.vision.models import resnet18 as tr18
    tm = tr18(num_classes=10, device="cpu")
    tm.load_state_dict(state_from_jax(state, tm))
    return tm


def test_state_from_jax_carries_the_resnet_buffers(r18_pair):
    jm, state = r18_pair
    tm = _r18(state)
    names = set(tm.state_dict())
    assert names == set(state)
    assert "layer1.0.bn1._mean" in names and \
        "layer2.0.downsample.1._variance" in names
    assert sum(k.endswith("._mean") for k in names) == 20   # ResNet-18
    np.testing.assert_array_equal(tm.layer3[1].bn2._variance.numpy(),
                                  state["layer3.1.bn2._variance"])
    x = np.random.default_rng(10).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    jm.eval()
    tm.eval()
    # eval normalizes with the given statistics: one formula in both
    # arms, so the JAX plain arm (its CPU default) is the reference here
    want = _np(jm(to_tensor(x)))
    with tflags.flags_guard(**KERNELS), torch.no_grad():
        got = tm(_t(x))
    np.testing.assert_allclose(got.numpy(), want, **MOD_TOL)


@pytest.mark.parametrize("flags", [KERNELS, PLAIN], ids=["kernel", "plain"])
def test_bottleneck_stack_forward_and_grads_match_jax(flags):
    """ResNet-50's block: a strided bottleneck with its downsample, then
    an identity one, in training mode; output, input gradient, every
    parameter gradient and the running statistics."""
    from paddle1_tpu.nn.layer_conv_pool import Conv2D as JConv
    from paddle1_tpu.nn.layer_norm_act import BatchNorm2D as JBN
    from paddle1_tpu.nn.layer_norm_act import Sequential as JSeq
    from paddle1_tpu.vision.models.resnet import BottleneckBlock as JB
    from paddle1_tpu_torch.nn import BatchNorm2D as TBN
    from paddle1_tpu_torch.nn import Conv2D as TConv
    from paddle1_tpu_torch.nn import Sequential as TSeq
    from paddle1_tpu_torch.vision.models.resnet import BottleneckBlock as TB
    paddle.seed(11)
    jstack = JSeq(JB(32, 16, stride=2, downsample=JSeq(
        JConv(32, 64, 1, stride=2, bias_attr=False), JBN(64))),
        JB(64, 16))
    tstack = TSeq(TB(32, 16, stride=2, downsample=TSeq(
        TConv(32, 64, 1, stride=2, bias_attr=False, device="cpu"),
        TBN(64, device="cpu")), device="cpu"), TB(64, 16, device="cpu"))
    tstack.load_state_dict(state_from_jax(_jax_state(jstack), tstack))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 32, 8, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 64, 4, 4)).astype(np.float32)
    xj = to_tensor(x)
    xj.stop_gradient = False
    with jax_flags_guard(**flags):
        yj = jstack(xj)
        (yj * to_tensor(cot)).sum().backward()
    xt = _t(x).requires_grad_()
    with tflags.flags_guard(**flags):
        yt = tstack(xt)
        (yt * _t(cot)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), _np(yj), **MOD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _np(xj.grad), **MOD_TOL)
    jparams = dict(jstack.named_parameters())
    for name, p in tstack.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jparams[name].grad),
                                   err_msg=name, **MOD_TOL)
    jstate = _jax_state(jstack)
    for name, buf in tstack.named_buffers():
        np.testing.assert_allclose(buf.numpy(), jstate[name], err_msg=name,
                                   **MOD_TOL)


def _images(seed, n=8, size=32, classes=10):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 3, size, size)).astype(np.float32),
            "y": rng.integers(0, classes, (n,)).astype(np.int64)}


STEPS = 3


@pytest.fixture(scope="module")
def r18_jax_steps(r18_pair):
    """Three Momentum steps of the JAX engine on ResNet-18 (its plain
    batch-norm arm: the JAX package's CPU default)."""
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh
    jm, state = r18_pair
    jm.train()

    def jloss(m, b):
        return jF.cross_entropy(m(Tensor(b["x"])), Tensor(b["y"]))
    jeng = JEngine(jm, paddle.optimizer.Momentum(
        learning_rate=1e-3, momentum=0.9, parameters=jm.parameters()),
        jloss, mesh=build_mesh(dp=1, devices=[jax.devices()[0]]))
    batch = _images(13)
    losses = [float(jeng.step(batch)) for _ in range(STEPS)]
    return losses, {k: np.asarray(v) for k, v in jeng.params.items()}


@pytest.mark.parametrize("flags", [PLAIN, KERNELS], ids=["plain",
                                                          "kernel"])
def test_resnet18_three_momentum_steps_match_jax_engine(r18_pair,
                                                        r18_jax_steps,
                                                        flags):
    """Losses, parameters and running statistics within 1e-4. The port's
    kernel arm (plain versions of the kernels on the CPU) is held to the
    JAX plain arm too: the two arms differ only in rounding (one-pass vs
    two-pass variance), far inside the tolerance at this size."""
    jlosses, jparams = r18_jax_steps
    tm = _r18(r18_pair[1])
    tm.train()
    eng = ParallelEngine(tm, Momentum(learning_rate=1e-3, momentum=0.9,
                                      parameters=tm.parameters()),
                         lambda m, b: tF.cross_entropy(m(b["x"]), b["y"]))
    with tflags.flags_guard(**flags):
        losses = [float(eng.step(_images(13))) for _ in range(STEPS)]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=0)
    state = tm.state_dict()
    assert set(state) == set(jparams)
    for name, t in state.items():
        np.testing.assert_allclose(t.numpy(), jparams[name], err_msg=name,
                                   **MOD_TOL)


def _frozen_pair(amp=None):
    """A conv + frozen-statistics BN + head, both packages, identical
    weights and running statistics."""
    from paddle1_tpu.nn import Linear as JLin
    from paddle1_tpu.nn.layer_conv_pool import Conv2D as JConv
    from paddle1_tpu.nn.layer_norm_act import BatchNorm2D as JBN
    from paddle1_tpu.nn.layer_norm_act import Sequential as JSeq
    from paddle1_tpu_torch.nn import BatchNorm2D as TBN
    from paddle1_tpu_torch.nn import Conv2D as TConv
    from paddle1_tpu_torch.nn import Linear as TLin
    from paddle1_tpu_torch.nn import Sequential as TSeq

    class JNet(JSeq):
        def forward(self, x):
            y = self[1](self[0](x))
            return self[2](y.mean(axis=[2, 3]))

    class TNet(TSeq):
        def forward(self, x):
            return self[2](self[1](self[0](x)).mean(dim=(2, 3)))
    paddle.seed(14)
    jn = JNet(JConv(3, 16, 3, padding=1), JBN(16, use_global_stats=True),
              JLin(16, 4))
    tn = TNet(TConv(3, 16, 3, padding=1, device="cpu"),
              TBN(16, use_global_stats=True, device="cpu"),
              TLin(16, 4, device="cpu"))
    state = _jax_state(jn)
    rng = np.random.default_rng(14)
    # running statistics that bf16 cannot hold exactly
    state["1._mean"] = (rng.standard_normal(16) * 0.3 + 1.0 / 3).astype(
        np.float32)
    state["1._variance"] = rng.uniform(0.7, 1.3, 16).astype(np.float32) \
        + np.float32(1.0 / 1024)
    jn.set_state_dict({k: to_tensor(v) for k, v in state.items()})
    tn.load_state_dict(state_from_jax(state, tn))
    return jn, tn, state


def test_frozen_statistics_move_with_their_gradient_like_the_jax_engine():
    """``use_global_stats=True`` inside the engine: the JAX engine
    differentiates its whole state and lets the optimizer update the
    running statistics; the port does the same."""
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh
    jn, tn, state = _frozen_pair()
    batch = _images(15, n=4, size=8, classes=4)
    jeng = JEngine(jn, paddle.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jn.parameters()),
        lambda m, b: jF.cross_entropy(m(Tensor(b["x"])), Tensor(b["y"])),
        mesh=build_mesh(dp=1, devices=[jax.devices()[0]]))
    with jax_flags_guard(**KERNELS):
        jl = [float(jeng.step(batch)) for _ in range(2)]
    eng = ParallelEngine(tn, Momentum(learning_rate=0.1, momentum=0.9,
                                      parameters=tn.parameters()),
                         lambda m, b: tF.cross_entropy(m(b["x"]), b["y"]))
    with tflags.flags_guard(**KERNELS):
        tl = [float(eng.step(batch)) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    moved = tn[1]._mean.numpy()
    assert np.abs(moved - state["1._mean"]).max() > 1e-4
    for name, t in tn.state_dict().items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jeng.params[name]),
                                   err_msg=name, atol=1e-5, rtol=1e-5)


def test_bf16_engine_normalizes_with_bf16_rounded_running_stats(
        monkeypatch):
    """Under ``amp_dtype="bfloat16"`` the JAX engine casts the buffers
    with the parameters, so a given-statistics forward sees the running
    statistics rounded to bf16; the f32 buffers stay the masters."""
    _, tn, state = _frozen_pair()
    seen = []
    orig = tbn._norm_fwd
    monkeypatch.setattr(tbn, "_norm_fwd", lambda x2, m, v, *a: (
        seen.append((x2.dtype, m.detach().clone(), v.detach().clone())),
        orig(x2, m, v, *a))[1])
    eng = ParallelEngine(tn, Momentum(learning_rate=0.0, momentum=0.9,
                                      parameters=tn.parameters()),
                         lambda m, b: tF.cross_entropy(m(b["x"]), b["y"]),
                         amp_dtype="bfloat16")
    with tflags.flags_guard(**KERNELS):
        loss = float(eng.step(_images(16, n=4, size=8, classes=4)))
    assert np.isfinite(loss) and len(seen) == 1
    dt, m, v = seen[0]
    assert dt == m.dtype == v.dtype == torch.bfloat16
    want_m = _t(state["1._mean"]).to(torch.bfloat16)
    assert torch.equal(m, want_m)
    assert torch.equal(v, _t(state["1._variance"]).to(torch.bfloat16))
    assert not torch.equal(m.float(), _t(state["1._mean"]))
    assert tn[1]._mean.dtype == torch.float32     # masters stay f32


def test_engine_blends_batch_stats_once_per_step_from_the_old_buffers():
    from paddle1_tpu_torch.nn import BatchNorm2D
    bn = BatchNorm2D(8, momentum=0.5, device="cpu")
    x = torch.randn(4, 8, 3, 3)
    eng = ParallelEngine(bn, Momentum(learning_rate=0.1,
                                      parameters=bn.parameters()),
                         lambda m, b: (m(b) ** 2).mean())
    eng.step(x)
    bm, bv = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn._mean, 0.5 * bm, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(bn._variance, 0.5 + 0.5 * bv, atol=1e-6,
                               rtol=1e-5)
