"""The nine optimizer names the port added (``SGD``, ``Lars``, ``Ftrl``,
``Adagrad``, ``Adamax``, ``AdaDelta``/``Adadelta``, ``RMSProp``, ``Lamb``)
against the JAX package on the CPU, with ``Optimizer.minimize`` and the
functional path.

Each: a small net built in both packages with the JAX package's weights
carried across, three eager steps (``loss.backward(); opt.step();
sched.step(); opt.clear_grad()``) with weight decay (LAMB's own), a
global-norm clip and a ``StepDecay`` schedule, the parameters within
1e-5 after each step; the ``state_dict``'s slot names the reference's
and a ``set_state_dict`` into a fresh optimizer resuming bit for bit;
``minimize`` equal to ``backward`` + ``step``; ``functional_update``
equal to ``step`` and to the JAX package's ``functional_update``.
"""

import inspect

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax

TOL = 1e-5

# name -> its constructor keywords (weight_decay added where it takes one)
OPTS = {
    "SGD": {},
    "Momentum": {"momentum": 0.9},
    "Momentum-nesterov": {"momentum": 0.9, "use_nesterov": True},
    "Lars": {"momentum": 0.9, "lars_coeff": 0.01},
    "Ftrl": {"l1": 0.01, "l2": 0.02},
    "Ftrl-power": {"l1": 0.01, "lr_power": -1.0},
    "Adagrad": {"initial_accumulator_value": 0.1},
    "Adamax": {"beta1": 0.8},
    "AdaDelta": {"rho": 0.9, "epsilon": 1e-5},
    "Adadelta": {},
    "RMSProp": {},
    "RMSProp-centered": {"momentum": 0.9, "centered": True},
    "Lamb": {"lamb_weight_decay": 0.05},
}
SLOTS = {"SGD": (), "Momentum": ("velocity",), "Lars": ("velocity",), "Ftrl": ("squared", "linear"),
         "Adagrad": ("moment",), "Adamax": ("moment", "inf_norm"),
         "AdaDelta": ("avg_squared_grad", "avg_squared_update"),
         "Adadelta": ("avg_squared_grad", "avg_squared_update"),
         "RMSProp": ("mean_square", "mean_grad", "momentum"),
         "Lamb": ("moment1", "moment2")}


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _np(t):
    return t.detach().cpu().numpy() if type(t) is torch.Tensor else \
        np.asarray(t.numpy())


def _net(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(4, 6), nn.Tanh(), nn.Linear(6, 3))


def _nets(seed=0):
    jp.seed(seed)
    jn = _net(jp)
    with tp.utils.unique_name.guard():
        tn = _net(tp)
    tn.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jn.functional_state().items()}, tn))
    return jn, tn


def _batch(pkg, seed):
    rng = np.random.default_rng(seed)
    return (pkg.to_tensor(rng.standard_normal((5, 4)).astype(np.float32)),
            pkg.to_tensor(rng.standard_normal((5, 3)).astype(np.float32)))


def _loss(net, batch):
    x, y = batch
    d = net(x) - y
    return (d * d).mean()


def _opt(pkg, name, net, sched=None, clip=True):
    cls = getattr(pkg.optimizer, name.split("-")[0])
    kw = dict(OPTS[name])
    if "weight_decay" in inspect.signature(cls.__init__).parameters:
        kw["weight_decay"] = 0.01
    return cls(learning_rate=sched if sched is not None else 0.05,
               parameters=net.parameters(),
               grad_clip=pkg.nn.ClipGradByGlobalNorm(0.5) if clip else None,
               **kw)


def _params(net):
    return [_np(p) for p in net.parameters()]


@pytest.mark.parametrize("name", sorted(OPTS))
def test_three_clipped_scheduled_steps_match_the_reference(name):
    jn, tn = _nets()
    opts = []
    for pkg, net in ((jp, jn), (tp, tn)):
        sched = pkg.optimizer.lr.StepDecay(0.05, step_size=1, gamma=0.5)
        opts.append((sched, _opt(pkg, name, net, sched)))
    for step in range(3):
        for (pkg, net), (sched, opt) in zip(((jp, jn), (tp, tn)), opts):
            _loss(net, _batch(pkg, step)).backward()
            opt.step()
            sched.step()
            opt.clear_grad()
        for k, (a, b) in enumerate(zip(_params(jn), _params(tn))):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                       err_msg=f"step {step} param {k}")
    # the parameters moved
    assert not np.allclose(_params(tn)[0], _params(_nets()[1])[0])


@pytest.mark.parametrize("name", sorted(OPTS))
def test_state_dict_round_trip_resumes_bit_for_bit(name):
    jn, tn = _nets(1)
    _, twin = _nets(1)
    jopt, opt = _opt(jp, name, jn), _opt(tp, name, tn)
    for step in range(2):
        for pkg, net, o in ((jp, jn, jopt), (tp, tn, opt)):
            _loss(net, _batch(pkg, step)).backward()
            o.step()
            o.clear_grad()
    state = opt.state_dict()
    slots = SLOTS[name.split("-")[0]]
    assert {k.split("__")[1] for k in state if "__" in k} == set(slots)
    assert {k.split("__")[1] for k in jopt.state_dict() if "__" in k} == \
        set(slots)
    assert state["step"] == 2
    twin.load_state_dict(tn.state_dict())
    fresh = _opt(tp, name, twin)
    fresh.set_state_dict(state)
    for net, o in ((tn, opt), (twin, fresh)):
        _loss(net, _batch(tp, 5)).backward()
        o.step()
        o.clear_grad()
    for a, b in zip(_params(tn), _params(twin)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", ["SGD", "Adagrad", "Lamb", "RMSProp"])
def test_minimize_is_backward_then_step(name):
    _, a = _nets(2)
    _, b = _nets(2)
    oa, ob = _opt(tp, name, a), _opt(tp, name, b)
    _loss(a, _batch(tp, 0)).backward()
    oa.step()
    none, pairs = ob.minimize(_loss(b, _batch(tp, 0)))
    assert none is None and len(pairs) == len(list(b.parameters()))
    assert all(g is not None for _, g in pairs)
    for x, y in zip(_params(a), _params(b)):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_functional_update_equals_step_and_the_reference(name):
    """Two ``functional_update`` calls from ``functional_init`` against two
    unclipped ``step`` calls on the same gradients, and against the JAX
    package's ``functional_update`` (decay included, no clip)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 3), "b": (3,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    ps = {k: tp.create_parameter(list(v.shape), "float32")
          for k, v in p0.items()}
    for k, p in ps.items():
        p.set_value(p0[k])
    opt = _opt(tp, name, type("N", (), {"parameters": lambda self: list(
        ps.values())})(), clip=False)
    state = opt.functional_init({k: torch.from_numpy(v)
                                 for k, v in p0.items()})
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jparams = {k: jp.to_tensor(v).data for k, v in p0.items()}
    jopt = _opt(jp, name, type("N", (), {"parameters": lambda self: []})(),
                clip=False)
    jslots, jstep = jopt.functional_init(jparams)
    # the port starts a slot where step() does (Adagrad's initial
    # accumulator); the JAX package's functional_init starts every slot at
    # 0, so its state is given the same start
    jstate = ({k: {n: jp.to_tensor(_np(t)).data for n, t in s.items()}
               for k, s in state[0].items()}, jstep)
    assert set(jslots["w"]) == set(state[0]["w"])
    for g in grads:
        before = {k: v.clone() for k, v in params.items()}
        params, state = opt.functional_update(
            params, {k: torch.from_numpy(v) for k, v in g.items()}, state,
            0.05)
        for k in before:      # the inputs are not written
            assert not torch.equal(before[k], params[k])
        jparams, jstate = jopt.functional_update(
            jparams, {k: jp.to_tensor(v).data for k, v in g.items()}, jstate,
            0.05)
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        opt.clear_grad()
    assert int(state[1]) == 2 and state[1].dtype == torch.int32
    for k, p in ps.items():
        np.testing.assert_array_equal(_np(params[k]), _np(p))
        np.testing.assert_allclose(_np(params[k]), np.asarray(jparams[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert set(state[0]["w"]) == set(SLOTS[name.split("-")[0]])


@pytest.mark.parametrize("name", ["Momentum", "Lamb", "Adam"])
def test_functional_update_leaves_the_optimizer_as_it_was(name):
    """``functional_update`` on an optimizer that has stepped leaves its
    slots and step as they were, and its next step equals a twin's that
    never ran ``functional_update``."""
    nets = [_nets(4)[1] for _ in range(2)]
    opts = [getattr(tp.optimizer, name)(learning_rate=0.05,
                                        parameters=n.parameters())
            for n in nets]
    for net, o in zip(nets, opts):
        _loss(net, _batch(tp, 0)).backward()
        o.step()
        o.clear_grad()
    before = opts[0].state_dict()
    params = {f"p{i}": p.detach().clone()
              for i, p in enumerate(nets[0].parameters())}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    opts[0].functional_update(params, grads,
                              opts[0].functional_init(params), 0.05)
    after = opts[0].state_dict()
    assert after.keys() == before.keys() and after["step"] == 1
    for k, v in before.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(after[k], v), k
    for net, o in zip(nets, opts):
        _loss(net, _batch(tp, 1)).backward()
        o.step()
        o.clear_grad()
    for a, b in zip(_params(nets[0]), _params(nets[1])):
        np.testing.assert_array_equal(a, b)


def _positional(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()
            if p.kind != p.KEYWORD_ONLY]


def test_every_optimizer_name_is_ported_with_the_reference_signature():
    from paddle1_tpu.optimizer import optimizer as jo
    from paddle1_tpu_torch.optimizer import optimizer as to
    names = set(jo.__all__) | {"Ftrl"}
    assert names <= set(to.__all__)
    for name in names | {"Adadelta"}:
        jc, tc = getattr(jp.optimizer, name), getattr(tp.optimizer, name)
        assert _positional(tc.__init__) == _positional(jc.__init__), name
    assert tp.optimizer.Adadelta is tp.optimizer.AdaDelta
    for meth in ("minimize", "functional_init", "functional_update"):
        assert _positional(getattr(to.Optimizer, meth)) == \
            _positional(getattr(jo.Optimizer, meth)), meth


def test_lamb_takes_exclude_from_weight_decay_fn_and_does_not_read_it():
    """As the JAX package: a function excluding every parameter changes
    nothing (ROADMAP, "Notes on the reference")."""
    outs = []
    for fn in (None, lambda name: True):
        _, net = _nets(4)
        opt = tp.optimizer.Lamb(0.05, 0.1, parameters=net.parameters(),
                                exclude_from_weight_decay_fn=fn)
        _loss(net, _batch(tp, 0)).backward()
        opt.step()
        outs.append(_params(net))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_lars_takes_exclude_from_weight_decay_and_does_not_read_it():
    outs = []
    for names in (None, ["linear"]):
        _, net = _nets(5)
        opt = tp.optimizer.Lars(0.05, parameters=net.parameters(),
                                exclude_from_weight_decay=names)
        _loss(net, _batch(tp, 0)).backward()
        opt.step()
        outs.append(_params(net))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["SGD", "Adagrad", "RMSProp", "Lamb"])
def test_param_attr_rate_and_regularizer_apply(name):
    """The base class's rules hold for the new optimizers: a parameter at
    rate 0 stays, an ``L2Decay`` regularizer and a param group's rate
    match the JAX package after two steps."""
    models = []
    for pkg in (jp, tp):
        kw = {} if pkg is jp else {"device": "cpu"}
        with tp.utils.unique_name.guard():
            net = pkg.nn.Sequential(
                pkg.nn.Linear(4, 6, pkg.ParamAttr(
                    learning_rate=0.5,
                    regularizer=pkg.regularizer.L2Decay(0.1)),
                    pkg.ParamAttr(learning_rate=0.0), **kw),
                pkg.nn.Linear(6, 3, **kw))
        models.append(net)
    jn, tn = models
    tn.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jn.functional_state().items()}, tn))
    b0 = _np(tn[0].bias)
    for pkg, net in ((jp, jn), (tp, tn)):
        params = list(net.parameters())
        groups = [{"params": params[:2]},
                  {"params": params[2:], "learning_rate": 0.5}]
        opt = _opt(pkg, name, type("N", (), {"parameters":
                                             lambda self: groups})(),
                   clip=False)
        for step in range(2):
            _loss(net, _batch(pkg, step)).backward()
            opt.step()
            opt.clear_grad()
    np.testing.assert_array_equal(_np(tn[0].bias), b0)
    for k, (a, b) in enumerate(zip(_params(jn), _params(tn))):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", ["SGD", "Adagrad", "RMSProp-centered",
                                  "Lamb", "Lars", "Ftrl",
                                  "Momentum-nesterov"])
def test_bf16_parameters_update_in_f32_and_are_written_back(name):
    """A bf16 parameter is updated in f32 (its slots are f32) and written
    back rounded: one step equals the f32 step on the same (bf16-exact)
    values, rounded to bf16."""
    rng = np.random.default_rng(6)
    w, g = (torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32)).to(torch.bfloat16).float().numpy() for _ in range(2))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = tp.create_parameter([4, 3], "float32")
        p.set_value(w)
        if dtype == torch.bfloat16:
            p.data = p.data.to(dtype)
        opt = _opt(tp, name, type("N", (), {"parameters": lambda self: [p]})(),
                   clip=False)
        p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
        assert p.dtype == dtype
        assert all(t.dtype == torch.float32 for t in
                   opt._slots.get(id(p), {}).values())
        out[dtype] = p.detach().clone()
    torch.testing.assert_close(out[torch.bfloat16],
                               out[torch.float32].to(torch.bfloat16),
                               rtol=0, atol=0)
