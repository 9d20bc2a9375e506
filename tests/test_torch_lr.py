"""The port's LR schedulers (``paddle1_tpu_torch.optimizer.lr``) against the
JAX package's, and the optimizer's scheduler protocol.

Every scheduler runs 30 steps in both packages from the same arguments;
the rates agree exactly (both are the same host arithmetic in Python
floats). ``state_dict`` round trips: a scheduler restored from the
port's state at step 15 continues as the original does, and the state
equals the JAX package's.
"""

import math

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.optimizer import AdamW, Momentum
from paddle1_tpu_torch.optimizer import lr as tlr

jlr = paddle.optimizer.lr
STEPS = 30

# (class name, positional args, keyword args); lambdas are shared so both
# packages call the same function
_LAMBDA = (lambda e: 0.95 ** e)
_MULT = (lambda e: 0.9)
CASES = [
    ("NoamDecay", (64, 5), dict(learning_rate=1.0)),
    ("PiecewiseDecay", ([5, 10, 20], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.1,), dict(gamma=0.1)),
    ("InverseTimeDecay", (0.1,), dict(gamma=0.2)),
    ("PolynomialDecay", (0.1,), dict(decay_steps=20, end_lr=0.001,
                                     power=2.0)),
    ("PolynomialDecay", (0.1,), dict(decay_steps=8, end_lr=0.001,
                                     cycle=True)),
    ("LinearWarmup", (0.1,), dict(warmup_steps=5, start_lr=0.0,
                                  end_lr=0.1)),
    ("ExponentialDecay", (0.1,), dict(gamma=0.9)),
    ("MultiStepDecay", (0.1,), dict(milestones=[5, 15], gamma=0.5)),
    ("StepDecay", (0.1,), dict(step_size=7, gamma=0.5)),
    ("LambdaDecay", (0.1,), dict(lr_lambda=_LAMBDA)),
    ("ReduceOnPlateau", (0.1,), dict(patience=2, factor=0.5, cooldown=1)),
    ("CosineAnnealingDecay", (0.1,), dict(T_max=10, eta_min=0.001)),
    ("MultiplicativeDecay", (0.1,), dict(lr_lambda=_MULT)),
    ("OneCycleLR", (0.1,), dict(total_steps=STEPS)),
    ("OneCycleLR", (0.1,), dict(total_steps=STEPS, anneal_strategy="linear")),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=4)),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=3, step_size_down=5,
                                   mode="triangular2")),
    ("CyclicLR", (0.01, 0.1), dict(step_size_up=4, mode="exp_range",
                                   exp_gamma=0.9)),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]

# a plateau: falls, stalls, falls, stalls
METRICS = [1.0 / (1 + i) if i < 8 or 14 <= i < 18 else 0.1
           for i in range(STEPS)]


def _pair(name, args, kw):
    return getattr(jlr, name)(*args, **kw), getattr(tlr, name)(*args, **kw)


def _advance(s, i):
    if type(s).__name__ == "ReduceOnPlateau":
        s.step(METRICS[i])
    else:
        s.step()


def test_the_port_has_every_scheduler_of_the_jax_package():
    assert sorted(tlr.__all__) == sorted(jlr.__all__)
    assert len(jlr.__all__) == 16          # the base and 15 schedulers
    assert {c[0] for c in CASES} == set(jlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name,args,kw", CASES, ids=IDS)
def test_scheduler_matches_jax_over_30_steps(name, args, kw):
    js, ts = _pair(name, args, kw)
    got, want = [], []
    for i in range(STEPS):
        got.append(ts())
        want.append(js())
        assert ts.last_epoch == js.last_epoch
        _advance(js, i)
        _advance(ts, i)
    assert got == want
    assert len(set(got)) > 1 or name == "ReduceOnPlateau"


@pytest.mark.parametrize("name,args,kw", CASES, ids=IDS)
def test_scheduler_state_dict_round_trip(name, args, kw):
    js, ts = _pair(name, args, kw)
    for i in range(15):
        _advance(js, i)
        _advance(ts, i)
    sd = ts.state_dict()
    assert sd == js.state_dict()
    _, fresh = _pair(name, args, kw)
    fresh.set_state_dict(sd)
    for i in range(15, STEPS):
        assert fresh() == ts()
        _advance(fresh, i)
        _advance(ts, i)


def test_reduce_on_plateau_reduces_after_patience():
    s = tlr.ReduceOnPlateau(0.1, patience=2, factor=0.5)
    for m in (1.0, 1.0, 1.0, 1.0):
        s.step(m)
    assert s() == pytest.approx(0.05)
    s.step(0.5)
    assert s() == pytest.approx(0.05) and s.best == 0.5


def test_linear_warmup_over_polynomial_decay_matches_jax():
    def make(mod):
        return mod.LinearWarmup(mod.PolynomialDecay(1e-3, 20, end_lr=1e-5),
                                warmup_steps=4, start_lr=0.0, end_lr=1e-3)
    js, ts = make(jlr), make(tlr)
    for _ in range(STEPS):
        assert ts() == js()
        js.step()
        ts.step()


def test_base_scheduler_needs_get_lr():
    with pytest.raises(NotImplementedError):
        tlr.LRScheduler(0.1)


def test_optimizer_reads_sets_and_saves_the_scheduler():
    w = torch.nn.Parameter(torch.ones(4))
    sched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[w])
    assert opt._learning_rate is sched and opt.get_lr() == 0.1
    with pytest.raises(InvalidArgumentError, match="LRScheduler"):
        opt.set_lr(0.5)
    for _ in range(3):
        sched.step()
    assert opt.get_lr() == pytest.approx(0.05)
    w.grad = torch.ones(4)
    opt.step()
    sd = opt.state_dict()
    jw = paddle.create_parameter([4], "float32")
    jopt = paddle.optimizer.AdamW(
        learning_rate=jlr.StepDecay(0.1, step_size=2, gamma=0.5),
        parameters=[jw])
    for _ in range(3):
        jopt._learning_rate.step()
    assert sd["LR_Scheduler"] == jopt.state_dict()["LR_Scheduler"]
    fresh_sched = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    fresh = AdamW(learning_rate=fresh_sched, parameters=[w])
    fresh.set_state_dict(sd)
    assert fresh_sched.last_epoch == 3 and fresh.get_lr() == opt.get_lr()
    assert fresh.state_dict()["step"] == 1


def test_float_learning_rate_keeps_set_lr():
    w = torch.nn.Parameter(torch.ones(2))
    opt = Momentum(learning_rate=0.1, parameters=[w])
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25 and "LR_Scheduler" not in opt.state_dict()


def test_scheduled_rate_reaches_the_adam_update_each_step():
    # the update of step t uses the rate the scheduler holds at step t:
    # with weight decay 0 and a constant gradient, Adam's first steps move
    # each weight by lr_t (m/sqrt(v) = 1 after bias correction)
    w = torch.nn.Parameter(torch.zeros(3))
    sched = tlr.PiecewiseDecay([1, 2], [0.1, 0.01, 0.001])
    opt = AdamW(learning_rate=sched, parameters=[w], weight_decay=0.0)
    moved = []
    for _ in range(3):
        before = w.detach().clone()
        w.grad = torch.ones(3)
        opt.step()
        sched.step()
        moved.append(float((before - w.detach())[0]))
    np.testing.assert_allclose(moved, [0.1, 0.01, 0.001], rtol=1e-5)
    assert math.isclose(opt.get_lr(), 0.001)
