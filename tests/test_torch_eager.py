"""The eager dygraph slice of the PyTorch port against the JAX package, on
the CPU: the Paddle ``Tensor`` facade and autograd API, the softmax
functionals and layers around the row-softmax kernel, the cross-entropy
arms, ``save``/``load`` and BASELINE config 1's eager LeNet loop
(``benches.py:52-88``).

Both packages get the same numpy inputs and weights (moved across with
``convert.state_from_jax``); everything is float32. The JAX side runs its
Pallas softmax in interpret mode under ``fused_softmax="always"``, as its
own tests do; the port runs on CPU tensors (``device_guard("cpu")``), so
its kernel wrapper takes the plain version.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.autograd import engine as jengine
from paddle1_tpu.core import errors as jerr
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.vision.models.lenet import LeNet as JLeNet
from paddle1_tpu_torch.autograd import engine as tengine
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import errors as terr
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.ops import softmax as tsm
from paddle1_tpu_torch.vision.models import LeNet as TLeNet

TOL = dict(atol=1e-6, rtol=1e-6)
LENET_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with tp.device_guard("cpu"):
        yield


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _both(a, stop_gradient=True):
    return (jp.to_tensor(a, stop_gradient=stop_gradient),
            tp.to_tensor(a, stop_gradient=stop_gradient))


# ---------------------------------------------------------------------------
# the facade


@pytest.mark.parametrize("data", [
    1.5, 3, True, [1.0, 2.0], [[1, 2], [3, 4]], [True, False],
    np.ones((2, 2)), np.ones(3, np.float32), np.arange(4, dtype=np.int32),
    np.arange(3, dtype=np.int64), np.float64(2.5), np.ones(2, np.float16),
], ids=lambda d: type(d).__name__ + str(getattr(d, "dtype", "")))
def test_to_tensor_infers_the_jax_packages_dtype(data):
    """JAX runs without x64 here, so it stores an inferred int64 as
    int32: the port's int64 is held to that."""
    j, t = jp.to_tensor(data), tp.to_tensor(data)
    name = str(t.dtype).replace("torch.", "")
    assert {"int64": "int32"}.get(name, name) == str(j.dtype)
    assert isinstance(t, tp.Tensor) and t.place == tp.CPUPlace()
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert list(t.shape) == list(j.shape)


def test_to_tensor_with_a_dtype_and_a_default_dtype():
    for d in ("float16", "int32", "bfloat16", "float64"):
        assert tp.to_tensor([1, 2], dtype=d).dtype == \
            tp.core.dtype.convert_dtype(d)
    tp.set_default_dtype("float64")
    try:
        assert tp.to_tensor(1.0).dtype == torch.float64
        assert tp.to_tensor(np.ones(2)).dtype == torch.float64
    finally:
        tp.set_default_dtype("float32")
    with pytest.raises(terr.InvalidArgumentError):
        tp.set_default_dtype("int32")


def test_stop_gradient_defaults_match_the_jax_package():
    jx, tx = _both(_x(0, (3,)))
    assert jx.stop_gradient and tx.stop_gradient
    jw = jp.Parameter(_x(1, (3,)))
    tw = tp.Parameter(_x(1, (3,)))
    assert not jw.stop_gradient and not tw.stop_gradient
    assert tw.trainable and isinstance(tw, torch.nn.Parameter)
    jy, ty = jx * jw, tx * tw
    assert not jy.stop_gradient and not ty.stop_gradient
    assert isinstance(ty, tp.Tensor) and not isinstance(ty, tp.Parameter)
    assert ty.detach().stop_gradient and jy.detach().stop_gradient
    tw.trainable = False
    assert tw.stop_gradient and not tw.requires_grad
    with pytest.raises(terr.PreconditionNotMetError, match="detach"):
        ty.stop_gradient = True        # an op's output: detach() instead
    assert tp.to_tensor([1, 2], stop_gradient=False).stop_gradient


def test_grads_accumulate_over_two_backward_calls():
    a = _x(2, (4, 3))
    outs = []
    for pk in (jp, tp):
        x = pk.to_tensor(a, stop_gradient=False)
        for _ in range(2):
            ((x * x).sum() * 0.5).backward()
        outs.append(x.grad.numpy())
        x.clear_grad()
        assert x.grad is None
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], 2 * a, **TOL)


def test_a_second_backward_needs_retain_graph():
    a = _x(3, (5,))
    for pk, err in ((jp, TypeError), (tp, terr.PreconditionNotMetError)):
        x = pk.to_tensor(a, stop_gradient=False)
        y = (x.exp()).sum()
        y.backward()
        with pytest.raises(err):
            y.backward()
    grads = []
    for pk in (jp, tp):
        x = pk.to_tensor(a, stop_gradient=False)
        y = (x.exp()).sum()
        y.backward(retain_graph=True)
        y.backward()
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], **TOL)
    np.testing.assert_allclose(grads[1], 2 * np.exp(a), rtol=1e-6)


def test_backward_root_errors_are_typed():
    for pk, errs in ((jp, jerr), (tp, terr)):
        with pytest.raises(errs.PreconditionNotMetError):
            pk.to_tensor(_x(4, (2,))).sum().backward()
        x = pk.to_tensor(_x(4, (2,)), stop_gradient=False)
        with pytest.raises(errs.InvalidArgumentError):
            (x * 2).backward()


def test_hooks_match_the_jax_package():
    a = _x(5, (3,))
    res = []
    for pk in (jp, tp):
        x = pk.to_tensor(a, stop_gradient=False)
        y = x * 2.0
        seen = []
        y.register_hook(lambda g: g * 3.0)
        h = x.register_hook(lambda g: seen.append(g.numpy()))
        (y * y).sum().backward()
        h.remove()
        (x * 1.0).sum().backward()
        res.append((x.grad.numpy(), seen[0]))
        with pytest.raises((jerr.PreconditionNotMetError,
                            terr.PreconditionNotMetError)):
            pk.to_tensor(a).register_hook(lambda g: g)
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)
    assert len(res[1]) == 2


@pytest.mark.parametrize("expr", ["x*x", "exp+sin"])
def test_leaf_hooks_fire_per_incoming_edge_as_the_jax_package(expr):
    """A leaf used twice: the JAX engine fires its hook on each edge's
    gradient before accumulating (``autograd/engine.py:438-449``), so a
    squaring hook gives sum(g_i^2), not (sum g_i)^2."""
    a = np.array([0.5, -2.0, 3.0], np.float32)
    res = []
    for pk in (jp, tp):
        x = pk.to_tensor(a, stop_gradient=False)
        calls = []
        x.register_hook(lambda g: (calls.append(1), g * g)[1])
        y = x * x if expr == "x*x" else x.exp() + x.sin()
        y.sum().backward()
        res.append((x.grad.numpy(), len(calls)))
    (got, n_got), (want, n_want) = res[1], res[0]
    np.testing.assert_allclose(got, want, **TOL)
    assert n_got == n_want == 2
    if expr == "x*x":
        np.testing.assert_allclose(got, [0.5, 8.0, 18.0], **TOL)


def test_leaf_hooks_per_edge_through_grad_and_after_remove():
    """``paddle.grad`` sees the hooked edges too; a removed hook fires no
    more and its leaf costs nothing again."""
    from paddle1_tpu_torch.core import tensor as ptensor
    a = np.array([0.5, -2.0, 3.0], np.float32)
    res = []
    for pk in (jp, tp):
        x = pk.to_tensor(a, stop_gradient=False)
        h = x.register_hook(lambda g: g * g)
        gx, = pk.grad((x * x * 2.0).sum(), [x])
        h.remove()
        gy, = pk.grad((x * x).sum(), [x])
        res.append((gx.numpy(), gy.numpy()))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)
    assert not ptensor._hooked


def test_grad_with_and_without_allow_unused():
    a, b = _x(6, (3,)), _x(7, (3,))
    res = []
    for pk, errs in ((jp, jerr), (tp, terr)):
        x = pk.to_tensor(a, stop_gradient=False)
        z = pk.to_tensor(b, stop_gradient=False)
        y = (x * x * x).sum()
        with pytest.raises(errs.InvalidArgumentError):
            pk.grad(y, [x, z], retain_graph=True)
        gx, gz = pk.grad(y, [x, z], allow_unused=True)
        assert gz is None and x.grad is None
        res.append(gx.numpy())
    np.testing.assert_allclose(res[1], res[0], **TOL)
    np.testing.assert_allclose(res[1], 3 * a * a, rtol=1e-6)


def test_no_grad_context_and_decorator():
    for pk in (jp, tp):
        w = pk.to_tensor(_x(8, (3,)), stop_gradient=False)
        with pk.no_grad():
            assert (w * 2).stop_gradient
        assert not (w * 2).stop_gradient

        @pk.no_grad()
        def f(v):
            return v * 2
        assert f(w).stop_gradient
        assert pk.no_grad(lambda v: v + 1)(w).stop_gradient
    tp.set_grad_enabled(False)
    try:
        assert not tp.is_grad_enabled()
    finally:
        tp.set_grad_enabled(True)
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()
    assert tp.is_grad_enabled()


def _cube(pk):
    class Cube(pk.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * x * x * scale

        @staticmethod
        def backward(ctx, dy):
            x, = ctx.saved_tensor
            return dy * 3.0 * x * x * ctx.scale
    return Cube


def test_py_layer_matches_the_jax_package():
    a = _x(9, (4,))
    res = []
    for pk in (jp, tp):
        x = pk.to_tensor(a, stop_gradient=False)
        y = _cube(pk).apply(x, scale=2.0)
        (y * y).sum().backward()
        res.append((y.numpy(), x.grad.numpy()))
        assert not y.stop_gradient
        with pk.no_grad():
            assert _cube(pk).apply(x).stop_gradient
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)
    assert isinstance(_cube(tp).apply(tp.to_tensor(a)), tp.Tensor)


def test_backward_end_callback_fires_once_per_backward():
    counts = {"jax": 0, "torch": 0}

    def jcb():
        counts["jax"] += 1

    def tcb():
        counts["torch"] += 1
    jengine.register_backward_end_callback(jcb)
    tengine.register_backward_end_callback(tcb)
    tengine.register_backward_end_callback(tcb)     # registered once
    try:
        for pk, key in ((jp, "jax"), (tp, "torch")):
            x = pk.to_tensor(_x(10, (3,)), stop_gradient=False)
            for _ in range(2):
                (x * x).sum().backward()
            pk.grad((x * x).sum(), [x])             # no callback
        assert counts == {"jax": 2, "torch": 2}
    finally:
        jengine._backward_end_callbacks.remove(jcb)
        tengine._backward_end_callbacks.remove(tcb)


def test_item_detach_clone_and_numpy():
    t = tp.to_tensor(_x(11, (2, 2)), stop_gradient=False)
    c = t.clone()
    assert isinstance(c, tp.Tensor) and not c.stop_gradient
    assert t.detach().stop_gradient
    assert tp.to_tensor(3.5).item() == 3.5
    b = tp.to_tensor([1.5, -2.25], dtype="bfloat16")
    assert b.numpy().dtype == np.float32
    np.testing.assert_array_equal(b.numpy(), [1.5, -2.25])
    assert tp.to_tensor([1, 2], place="cpu").place == tp.CPUPlace()


def test_places_and_seeds():
    assert tp.get_device() == tp.CPUPlace()
    with tp.device_guard(tp.CPUPlace()):
        assert tp.get_device() == tp.CPUPlace()
    with pytest.raises(terr.InvalidArgumentError):
        tp.set_device("tpu")
    assert tp.CUDAPlace(1) == tp.core.place._parse("gpu:1")
    tp.seed(7)
    a = torch.rand(3)
    state = tp.get_rng_state()
    b = torch.rand(3)
    tp.set_rng_state(state)
    assert torch.equal(torch.rand(3), b)
    tp.seed(7)
    assert torch.equal(torch.rand(3), a)


def test_optimizer_skips_a_parameter_frozen_after_its_grad_landed():
    """``paddle1_tpu/optimizer/optimizer.py:140-141`` selects on the
    gradient and ``not stop_gradient``."""
    a = np.array([0.5, -2.0, 3.0], np.float32)
    for pk in (jp, tp):
        w = pk.Parameter(a)
        opt = pk.optimizer.Adam(learning_rate=0.1, parameters=[w])
        (w * w).sum().backward()
        w.stop_gradient = True
        opt.step()
        np.testing.assert_array_equal(w.numpy(), a)
        w.stop_gradient = False
        opt.step()
        assert np.abs(w.numpy() - a).max() > 0.05


# ---------------------------------------------------------------------------
# softmax functionals and layers


@pytest.mark.parametrize("flag", ["always", "never"])
@pytest.mark.parametrize("axis,dtype", [(-1, None), (0, None),
                                        (-1, "float32"), (1, None),
                                        (-1, "float64")])
def test_functional_softmax_routes_like_the_jax_package(monkeypatch, flag,
                                                        axis, dtype):
    a = _x(12, (16, 128), 3.0)
    called = []
    orig = tsm.fused_softmax

    def spy(x):
        called.append(tuple(x.shape))
        return orig(x)
    monkeypatch.setattr(tsm, "fused_softmax", spy)
    with jax_flags_guard({"fused_softmax": flag}):
        want = jp.nn.functional.softmax(jp.to_tensor(a), axis=axis,
                                        dtype=dtype).numpy()
    with tflags.flags_guard(fused_softmax=flag):
        got = tp.nn.functional.softmax(tp.to_tensor(a), axis=axis,
                                       dtype=dtype)
    assert isinstance(got, tp.Tensor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert bool(called) == (flag == "always" and axis in (-1, 1))


def test_softmax_dtype_cast_comes_first():
    a = _x(13, (4, 8))
    got = tp.nn.functional.softmax(tp.to_tensor(a), dtype="float64")
    assert got.dtype == torch.float64
    want = jp.nn.functional.softmax(jp.to_tensor(a), dtype="float64")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_softmax_grad_through_the_kernel_route_matches_jax():
    a, g = _x(14, (8, 256), 2.0), _x(15, (8, 256))
    res = []
    for pk, guard in ((jp, jax_flags_guard({"fused_softmax": "always"})),
                      (tp, tflags.flags_guard(fused_softmax="always"))):
        with guard:
            x = pk.to_tensor(a, stop_gradient=False)
            y = pk.nn.functional.softmax(x)
            (y * pk.to_tensor(g)).sum().backward()
        res.append((y.numpy(), x.grad.numpy()))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layer,axis", [("Softmax", -1), ("Softmax", 0),
                                        ("LogSoftmax", -1),
                                        ("LogSoftmax", 1)])
def test_softmax_layers_match_the_jax_package(layer, axis):
    a = _x(16, (6, 10), 2.0)
    with jax_flags_guard({"fused_softmax": "always"}):
        want = getattr(jp.nn, layer)(axis=axis)(jp.to_tensor(a)).numpy()
    with tflags.flags_guard(fused_softmax="always"):
        got = getattr(tp.nn, layer)(axis=axis)(tp.to_tensor(a)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)


def test_softmax_in_place_and_log_softmax():
    a = _x(17, (3, 5))
    t = tp.to_tensor(a)
    out = tp.nn.functional.softmax_(t)
    assert out is t
    want = jp.nn.functional.softmax(jp.to_tensor(a)).numpy()
    np.testing.assert_allclose(t.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tp.nn.functional.log_softmax(tp.to_tensor(a), axis=0).numpy(),
        jp.nn.functional.log_softmax(jp.to_tensor(a), axis=0).numpy(),
        atol=2e-6, rtol=1e-6)


def test_softmax_in_place_takes_the_new_dtype_as_the_jax_package():
    a = _x(27, (3, 5))
    res = []
    for pk in (jp, tp):
        x = pk.to_tensor(a)
        assert pk.nn.functional.softmax_(x, dtype="float16") is x
        res.append((str(x.dtype).replace("torch.", "").replace(
            "paddle.", ""), x.numpy().astype(np.float32)))
    assert res[1][0] == res[0][0] == "float16"
    np.testing.assert_allclose(res[1][1], res[0][1], atol=1e-3)


def test_softmax_in_place_on_a_leaf_replaces_it_as_the_jax_package():
    """The JAX package's ``_replace_impl`` rebinds x to the softmax's
    output: x holds the probabilities and a later loss on x reaches
    x.grad through the softmax's backward."""
    a, g = _x(28, (4, 6), 2.0), _x(29, (4, 6))
    res = []
    for pk in (jp, tp):
        x = pk.to_tensor(a, stop_gradient=False)
        assert pk.nn.functional.softmax_(x) is x
        assert not x.stop_gradient
        (x * pk.to_tensor(g)).sum().backward()
        res.append((x.numpy(), x.grad.numpy()))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_returns_the_softmax(soft):
    logits = _x(18, (16, 128), 2.0)
    rng = np.random.default_rng(19)
    if soft:
        lab = rng.random((16, 128)).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = rng.integers(0, 128, (16, 1)).astype(np.int64)
    with jax_flags_guard({"fused_softmax": "always"}):
        jl, jsm = jp.nn.functional.softmax_with_cross_entropy(
            jp.to_tensor(logits), jp.to_tensor(lab), soft_label=soft,
            return_softmax=True)
    with tflags.flags_guard(fused_softmax="always"):
        tl, tsmx = tp.nn.functional.softmax_with_cross_entropy(
            tp.to_tensor(logits), tp.to_tensor(lab), soft_label=soft,
            return_softmax=True)
    assert list(tl.shape) == list(jl.shape) == [16, 1]
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=2e-6, rtol=1e-6)
    np.testing.assert_allclose(tsmx.numpy(), jsm.numpy(), **TOL)


@pytest.mark.parametrize("kw", [
    dict(use_softmax=False), dict(soft_label=True),
    dict(label_smoothing=0.1), dict(soft_label=True, label_smoothing=0.2),
    dict(reduction="sum"), dict(reduction="none", ignore_index=3),
    dict(axis=1, reduction="none"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_cross_entropy_arms_match_the_jax_package(kw):
    rng = np.random.default_rng(20)
    x = _x(21, (6, 5), 2.0)
    if not kw.get("use_softmax", True):
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    if kw.get("soft_label"):
        lab = rng.random((6, 5)).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = rng.integers(0, 5, (6,)).astype(np.int64)
    want = jp.nn.functional.cross_entropy(jp.to_tensor(x),
                                          jp.to_tensor(lab), **kw).numpy()
    got = tp.nn.functional.cross_entropy(tp.to_tensor(x), tp.to_tensor(lab),
                                         **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# LeNet, BASELINE config 1


def _lenet_pair(seed=0):
    jp.seed(seed)
    jm = JLeNet()
    tm = TLeNet(device="cpu")
    tm.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jm.functional_state().items()}, tm))
    return jm, tm


def test_lenet_weights_cross_and_logits_agree():
    jm, tm = _lenet_pair()
    assert sorted(dict(tm.named_parameters())) == \
        sorted(jm.functional_state())
    assert all(isinstance(p, tp.Parameter) and not p.stop_gradient
               for p in tm.parameters())
    x = _x(22, (8, 1, 28, 28))
    want = jm(jp.to_tensor(x)).numpy()
    got = tm(tp.to_tensor(x))
    assert isinstance(got, tp.Tensor) and not got.stop_gradient
    np.testing.assert_allclose(got.numpy(), want, **LENET_TOL)
    with jax_flags_guard({"fused_softmax": "always"}), jp.no_grad():
        jprob = jp.nn.functional.softmax(jm(jp.to_tensor(x))).numpy()
    with tflags.flags_guard(fused_softmax="always"), tp.no_grad():
        tprob = tp.nn.functional.softmax(tm(tp.to_tensor(x)))
    assert tprob.stop_gradient
    np.testing.assert_allclose(tprob.numpy(), jprob, **TOL)


def _eager_steps(pk, model, x, y, steps):
    """benches.py:72-78's loop: forward, cross entropy, backward, Adam
    step, clear_grad; returns the losses."""
    opt = pk.optimizer.Adam(learning_rate=1e-3,
                            parameters=model.parameters())
    losses = []
    for _ in range(steps):
        loss = pk.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, opt


def test_three_eager_adam_steps_match_the_jax_loop():
    jm, tm = _lenet_pair(1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (16,)).astype(np.int64)
    jl, _ = _eager_steps(jp, jm, jp.to_tensor(x), jp.to_tensor(y), 3)
    tl, _ = _eager_steps(tp, tm, tp.to_tensor(x), tp.to_tensor(y), 3)
    np.testing.assert_allclose(tl, jl, **STEP_TOL)
    assert tl[-1] < tl[0]
    jstate = jm.functional_state()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]),
                                   err_msg=k, **STEP_TOL)


# ---------------------------------------------------------------------------
# save / load


def test_save_load_round_trips_nested_state(tmp_path):
    w = tp.Parameter(_x(23, (3, 2)))
    state = {"w": w, "bf16": tp.to_tensor(_x(24, (4,)), dtype="bfloat16"),
             "ints": [tp.to_tensor([1, 2, 3]), (7, "seven")],
             "plain": torch.arange(3, dtype=torch.int32), "step": 5}
    path = str(tmp_path / "sub" / "state.pdparams")
    tp.save(state, path)
    got = tp.load(path)
    assert isinstance(got["w"], tp.Parameter) and not got["w"].stop_gradient
    assert torch.equal(got["w"], w.detach())
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"].view(torch.int16),
                       state["bf16"].view(torch.int16))
    assert isinstance(got["ints"], list) and got["ints"][1] == (7, "seven")
    assert torch.equal(got["ints"][0], state["ints"][0])
    assert got["plain"].dtype == torch.int32 and got["step"] == 5
    raw = tp.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)
    np.testing.assert_array_equal(raw["bf16"], state["bf16"].numpy())


def test_jax_written_files_are_another_format(tmp_path):
    path = str(tmp_path / "jax.pdparams")
    jp.save({"w": jp.to_tensor(_x(25, (2,)))}, path)
    with open(path, "rb") as f:
        assert b"paddle1_tpu.framework.io" in f.read()
    tpath = str(tmp_path / "torch.pdparams")
    tp.save({"w": tp.to_tensor(_x(25, (2,)))}, tpath)
    with open(tpath, "rb") as f:
        assert b"paddle1_tpu_torch.framework.io" in f.read()


def test_save_load_resumes_an_eager_run_bit_for_bit(tmp_path):
    rng = np.random.default_rng(1)
    x = tp.to_tensor(rng.standard_normal((8, 1, 28, 28)).astype(np.float32))
    y = tp.to_tensor(rng.integers(0, 10, (8,)).astype(np.int64))
    tp.seed(3)
    # each model in a fresh name space, as in a new process: the Adam
    # state is keyed by parameter name, as in the JAX package
    with tp.utils.unique_name.guard():
        m = TLeNet(device="cpu")
    _, opt = _eager_steps(tp, m, x, y, 2)
    path = str(tmp_path / "ckpt.pd")
    tp.save({"model": m.state_dict(), "opt": opt.state_dict()}, path)
    ref, _ = _eager_steps_with(opt, m, x, y)
    ck = tp.load(path)
    with tp.utils.unique_name.guard():
        m2 = TLeNet(device="cpu")
    m2.load_state_dict(ck["model"])
    opt2 = tp.optimizer.Adam(learning_rate=1e-3, parameters=m2.parameters())
    opt2.set_state_dict(ck["opt"])
    got, _ = _eager_steps_with(opt2, m2, x, y)
    assert got == ref
    for a, b in zip(m.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def _eager_steps_with(opt, model, x, y):
    loss = tp.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.numpy()), opt


def test_optimizer_step_reads_paddle_tensors_as_plain_tensors(monkeypatch):
    """The update pays no re-wrapping: no ``__torch_function__`` call of
    the facade during ``Adam.step()`` / ``clear_grad()``."""
    from paddle1_tpu_torch.core import tensor as ptensor
    tm = TLeNet(device="cpu")
    opt = tp.optimizer.Adam(learning_rate=1e-3, parameters=tm.parameters())
    x = tp.to_tensor(_x(26, (4, 1, 28, 28)))
    tp.nn.functional.cross_entropy(tm(x), tp.to_tensor([1, 2, 3, 4])) \
        .backward()
    before = [p.detach().clone() for p in tm.parameters()]
    calls = []
    orig = ptensor.Tensor.__torch_function__.__func__

    def counting(cls, func, types, args=(), kwargs=None):
        calls.append(func)
        return orig(cls, func, types, args, kwargs)
    monkeypatch.setattr(ptensor.Tensor, "__torch_function__",
                        classmethod(counting))
    opt.step()
    opt.clear_grad()
    monkeypatch.undo()
    assert calls == []
    assert all(not torch.equal(a, b) for a, b in zip(before, tm.parameters()))
    assert all(p.grad is None for p in tm.parameters())


def test_lenet_follows_the_current_place():
    with tp.device_guard("cpu"):
        m = TLeNet()
    assert all(p.device.type == "cpu" for p in m.parameters())
