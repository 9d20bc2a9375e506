"""MobileNetV1 and MobileNetV2 of the port against the JAX package on the
CPU (``vision/models/mobilenet.py``).

A narrow MobileNetV2 and a narrow MobileNetV1 (``scale=0.25``) at 8 x 3 x
64², the JAX package's seeded weights carried across by
``convert.state_from_jax``, on the plain path and on the kernels'
wrappers (``flags_guard(conv_nhwc="always", fused_bn="always",
fused_bn_bwd="always")``: every batch norm through them, their plain
versions on CPU tensors), each result within 1e-4 of the JAX package's
(run as one compiled program, :class:`JaxReference`):

- the training-mode forward's loss and logits, the first step's
  gradients, the running statistics after it and the eval forward from
  them;
- three eager ``Momentum(0.045, 0.9, weight_decay=L2Decay(4e-5))`` steps
  through ``nn.CrossEntropyLoss`` of the narrow V2 on the kernels'
  wrappers beside the JAX package's loop (its forward and backward one
  compiled program, its eager ``Momentum.step`` on those gradients), each
  step taken by both from the same parameters, running statistics and
  velocities (the JAX package's, copied to the port before it): the loss,
  the parameters, the running statistics, the update and the velocity
  after each step; then the eval forward. Taken apart, the two
  trajectories part by chaos, not by a fault: the JAX package's own
  trajectory, its parameters moved by 1e-7 (about one f32 rounding) after
  the first step, gives logits 0.40 away at the third.

Values are compared elementwise (``rtol`` and ``atol`` 1e-4); a gradient,
an update or a velocity as the L2 norm of its error over the JAX
package's, that denominator at least 1e-2 of the largest parameter's.
The floor is for gradients that are zero or nearly so: the projections'
batch-norm biases of MobileNetV2 (zero in exact arithmetic, since the next
batch norm removes any shift) and V1's stem batch-norm weight (1e-5 of the
largest). What is left of them in f32 is the rounding of terms that
cancel over up to 32768 rows: the two packages' values differ by 1.6e-7
of the largest norm.

Both packages take the gradients on the same linear piece of each ReLU
and ReLU6. Where a pre-activation lies within an f32 rounding of a kink
(0, or 6), the two f32 forwards, which sum in different orders, may put it
on either side, and its gradient jumps between 0 and 1. One such element
of the narrow V2 at this batch (features.15.conv.1's ReLU6, after a batch
norm of 32 rows) moves the JAX package's f32 gradient of every parameter
before it 1-2 % from float64, while the port's f32 one, on float64's side,
stays within 1e-5 and the rest of the JAX package's within 5e-5. So
:class:`JaxReference` records which side of its kinks each element of
each activation lies on, and :func:`on_pieces` takes the port's
activation gradients on those sides (its forward values stay its own);
an element the two packages place on different sides must lie within
1e-4 of the kink.

At 32² the last depthwise batch norms of the narrow V2 see 1 x 1 maps
whose channels are nearly constant across the batch (variance 1.6e-7,
far below epsilon), and every f32 gradient there is chaotic; at 64² the
smallest per-channel variance is 7e-3. The classifier's dropout is set
to 0 in both packages: their masks come from different generators. V1's
half of the first check, the full-width ``mobilenet_v2()``'s size (3.5 M
parameters, 52 batch norms) and its state dict's crossing run in
``tests/test_torch_mobilenet_v1.py``.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.flags import flags_guard

TOL = dict(rtol=1e-4, atol=1e-4)
# a gradient's error over the JAX package's gradient, and the least
# denominator, a share of the largest parameter's (module docstring)
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-2
# the activations whose gradients are taken on the JAX package's pieces,
# and how near its kink an element the two packages place apart must lie
ACTS, KINK_TOL = ("ReLU", "ReLU6"), 1e-4
# the three-step loop: Sandler et al. 2018's optimizer settings
STEP_LR, MOMENTUM, DECAY = 0.045, 0.9, 4e-5
KERNEL_FLAGS = dict(conv_nhwc="always", fused_bn="always",
                    fused_bn_bwd="always")


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    """The JAX package's narrow model (seeded, dropout 0), its
    :class:`JaxReference` and its initial state, built once a process: each
    test starts from that state, so the compiled programs are reused."""
    jp.seed(20)
    jm = getattr(jp.vision.models, name)(scale=0.25, num_classes=10)
    for layer in jm.sublayers():
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0
    init = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    return jm, JaxReference(jm), init


def _pair(name):
    """The JAX package's model (at its initial state, in training mode), its
    reference runner, and the port's model with its weights."""
    jm, ref, init = _jax_model(name)
    jm.set_state_dict({k: jp.to_tensor(v) for k, v in init.items()})
    jm.train()
    with tp.utils.unique_name.guard():
        tm = getattr(tp.vision.models, name)(scale=0.25, num_classes=10)
    tm.load_state_dict(state_from_jax(init, tm))
    for layer in tm.modules():
        if type(layer).__name__ == "Dropout":
            layer.p = 0.0
    return jm, ref, tm


def _batch(n=8, img=64, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, img, img)).astype(np.float32),
            rng.integers(0, classes, (n,)).astype(np.int64))


def _grads(m):
    return {k: _np(p.grad).astype(np.float64)
            for k, p in m.named_parameters() if p.grad is not None}


def _states(m):
    return {k: _np(v) for k, v in m.state_dict().items()}


def _close(want, got, what):
    assert sorted(want) == sorted(got), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **TOL)


def _grad_gaps(got, want):
    """Each parameter's ``|got - want|`` (L2) over ``|want|``, that
    denominator at least GRAD_FLOOR of the largest parameter's (the module
    docstring): ``{name: gap}``."""
    top = max(np.linalg.norm(g) for g in want.values())
    return {k: np.linalg.norm(got[k] - g) /
            max(np.linalg.norm(g), GRAD_FLOOR * top)
            for k, g in want.items()}


def _close_grads(want, got, what):
    assert sorted(want) == sorted(got), what
    gaps = _grad_gaps(got, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (what, worst, gaps[worst])


def _piece(kind, x):
    """Where the activation ``kind`` has gradient 1 (``x`` a torch tensor
    or a JAX array): above 0, and for ReLU6 below 6."""
    return (x > 0) & (x < 6) if kind == "ReLU6" else x > 0


def _kink_distance(kind, x):
    d = torch.abs(x)
    return torch.minimum(d, torch.abs(x - 6)) if kind == "ReLU6" else d


@contextlib.contextmanager
def on_pieces(tm, pieces):
    """The port's ``tm`` with each ReLU/ReLU6 layer's gradient taken on
    ``pieces`` (``{layer name: bool array}``, :meth:`JaxReference.
    train_step`'s), its forward values unchanged. Yields a list that
    collects, for each activation, the largest distance to its kink of an
    element the port places on another piece."""
    far = []

    def hook(name, kind):
        def fn(mod, inputs, out):
            x = inputs[0]
            want = torch.from_numpy(np.array(pieces[name]))
            xd = x.detach()
            off = _piece(kind, xd) != want
            if bool(off.any()):
                far.append(float(_kink_distance(kind, xd[off]).max()))
            return out.detach() + (x - xd) * want.to(x.dtype)
        return fn

    acts = {n: type(m).__name__ for n, m in tm.named_modules()
            if type(m).__name__ in ACTS}
    assert sorted(acts) == sorted(pieces)
    handles = [m.register_forward_hook(hook(n, acts[n]))
               for n, m in tm.named_modules() if n in acts]
    try:
        yield far
    finally:
        for h in handles:
            h.remove()


class JaxReference:
    """The JAX package's ``jm`` run as one compiled program a call: its
    training forward, ``nn.CrossEntropyLoss`` and backward under
    ``jax.jit(jax.value_and_grad(...))`` through ``Layer.
    load_functional_state``, the running-statistics updates captured by
    ``collect_stat_updates`` and blended into ``jm``'s buffers as its eager
    batch norms blend them (``new = m * old + (1 - m) * batch``), and the
    piece of each ReLU/ReLU6 input (:func:`_piece`, read by a forward post
    hook); and its eval forward under ``jax.jit``. The JAX package's eager
    op-by-op dispatch compiles each op shape of these models, about half a
    minute a model, where one program compiles in seconds; the values are
    the JAX package's functions either way."""

    def __init__(self, jm):
        import jax
        from paddle1_tpu.nn.functional.norm import collect_stat_updates
        self.jm = jm
        self.pnames = [k for k, _ in jm.named_parameters()]
        self._sink = None

        def record(name, kind):
            def hook(layer, inputs, outputs):
                if self._sink is not None:
                    self._sink[name] = _piece(kind, inputs[0].data)
            return hook

        for name, layer in jm.named_sublayers():
            if type(layer).__name__ in ACTS:
                layer.register_forward_post_hook(
                    record(name, type(layer).__name__))

        def loss_fn(params, rest, x, y):
            self._sink = {}
            try:
                with jm.load_functional_state({**params, **rest}):
                    with collect_stat_updates() as sink:
                        out = jm(jp.to_tensor(x))
                        loss = jp.nn.CrossEntropyLoss()(out,
                                                        jp.to_tensor(y))
                pieces = self._sink
            finally:
                self._sink = None
            key = {id(v): k for k, v in rest.items()}
            stats = {key[id(u.old_mean)]: (u.mean, u.var, u.momentum)
                     for u in sink}
            return loss.data, (out.data, stats, pieces)

        def eval_fn(state, x):
            with jm.load_functional_state(state):
                return jm(jp.to_tensor(x)).data

        self._train = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        self._eval = jax.jit(eval_fn)

    def train_step(self, x, y):
        """``(loss, logits, {name: gradient}, {activation: piece})`` of one
        training forward and backward; ``jm``'s running statistics take
        the step's blend."""
        state = self.jm.functional_state()
        params = {k: state[k] for k in self.pnames}
        rest = {k: v for k, v in state.items() if k not in params}
        (loss, (out, stats, pieces)), grads = self._train(params, rest, x,
                                                          y)
        sd = self.jm.state_dict()
        for mean_key, (mean, var, mom) in stats.items():
            var_key = mean_key[:-len("_mean")] + "_variance"
            for k, batch in ((mean_key, mean), (var_key, var)):
                sd[k]._data = mom * sd[k].data + (1 - mom) * batch
        return (np.asarray(loss), np.asarray(out),
                {k: np.asarray(g).astype(np.float64)
                 for k, g in grads.items()},
                {k: np.asarray(v) for k, v in pieces.items()})

    def eval_forward(self, x):
        self.jm.eval()
        return np.asarray(self._eval(self.jm.functional_state(), x))


def check_forward_gradients_and_eval(name, flags):
    """The first test of the module docstring for ``name`` on the
    ``kernels`` or ``plain`` flag set (``tests/test_torch_mobilenet_v1.py``
    runs it for V1 in a file of its own: each model's first JAX run
    compiles its ops, about half a minute, so the two run on two test
    workers)."""
    jm, ref, tm = _pair(name)
    x, y = _batch()
    jloss, jout, jg, pieces = ref.train_step(x, y)
    mode = "always" if flags == "kernels" else "never"
    with flags_guard(conv_nhwc=mode, fused_bn=mode, fused_bn_bwd=mode), \
            on_pieces(tm, pieces) as far:
        tout = tm(tp.to_tensor(x))
        tloss = tp.nn.CrossEntropyLoss()(tout, tp.to_tensor(y))
        tloss.backward()
    assert max(far, default=0.0) <= KINK_TOL, far
    np.testing.assert_allclose(_np(tloss), jloss, **TOL)
    np.testing.assert_allclose(_np(tout), jout, **TOL)
    _close_grads(jg, _grads(tm), "first-step gradients")
    _close(_states(jm), _states(tm), "state after a training forward")
    tm.eval()
    with flags_guard(conv_nhwc=mode, fused_bn=mode):
        with tp.no_grad():
            tout = tm(tp.to_tensor(x))
    np.testing.assert_allclose(_np(tout), ref.eval_forward(x), **TOL)


@pytest.mark.parametrize("flags", ["kernels", "plain"])
def test_mobilenet_v2_forward_gradients_and_eval_match_the_reference(flags):
    check_forward_gradients_and_eval("mobilenet_v2", flags)


def _optimizer(pkg, m):
    return pkg.optimizer.Momentum(
        STEP_LR, MOMENTUM, parameters=m.parameters(),
        weight_decay=pkg.regularizer.L2Decay(DECAY))


def _velocities(opt, m):
    """Each parameter's Momentum velocity by parameter name (both
    packages keep it in ``opt._slots[id(param)]["velocity"]``)."""
    return {k: _np(opt._slots[id(p)]["velocity"])
            for k, p in m.named_parameters()}


def test_three_momentum_steps_match_the_reference_eager_loop():
    jm, ref, tm = _pair("mobilenet_v2")
    jopt, topt = _optimizer(jp, jm), _optimizer(tp, tm)
    tcrit = tp.nn.CrossEntropyLoss()
    names = [k for k, _ in tm.named_parameters()]
    jparams = dict(jm.named_parameters())
    for step in range(3):
        x, y = _batch(seed=step)
        # the step from the JAX package's parameters, running statistics
        # and velocities (the module docstring)
        before = {k: np.asarray(v) for k, v in jm.functional_state().items()}
        tm.load_state_dict(state_from_jax(before, tm))
        velocity = _velocities(jopt, jm) if step else \
            {k: np.zeros_like(before[k]) for k in names}
        for k, q in tm.named_parameters():
            topt._slots_for(q)["velocity"].copy_(
                torch.from_numpy(velocity[k]))
        jloss, _, jgrads, pieces = ref.train_step(x, y)
        for k, g in jgrads.items():
            jparams[k].grad = g.astype(np.float32)
        jopt.step()
        jopt.clear_grad()
        with flags_guard(**KERNEL_FLAGS), on_pieces(tm, pieces) as far:
            tloss = tcrit(tm(tp.to_tensor(x)), tp.to_tensor(y))
            tloss.backward()
        topt.step()
        topt.clear_grad()
        what = f"step {step + 1}"
        assert max(far, default=0.0) <= KINK_TOL, (what, far)
        np.testing.assert_allclose(_np(tloss), jloss, **TOL)
        js, ts = _states(jm), _states(tm)
        _close(js, ts, what)
        _close_grads({k: js[k] - before[k] for k in names},
                     {k: ts[k] - before[k] for k in names},
                     f"{what} update")
        _close_grads(_velocities(jopt, jm), _velocities(topt, tm),
                     f"{what} velocity")
    tm.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jm.functional_state().items()}, tm))
    tm.eval()
    x, _ = _batch(seed=0)
    with flags_guard(**KERNEL_FLAGS), tp.no_grad():
        tout = tm(tp.to_tensor(x))
    np.testing.assert_allclose(_np(tout), ref.eval_forward(x), **TOL)
