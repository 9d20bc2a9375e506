"""The one-device training controls of the port's ``ParallelEngine``
against the JAX engine, on the tiny BERT of
``tests/test_parallel_engine.py`` (vocab 64, hidden 32, 2 layers of 2
heads, FFN 64, 16 positions) and its batch (8 x 16), from identical
weights (``state_from_jax``), in f32 on the CPU: ``grad_accum``,
``clip_global_norm``, ``check_finite`` and ``StepFuture``, ``step_many``,
``step_stream``, ``recompute``, a scheduled learning rate, the trace and
dispatch accounting, the in-flight window and the readback counter.
Losses and parameters agree to 1e-4, as the BERT engine test holds them
(``tests/test_torch_train.py``).
"""

import inspect
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.core.tensor import Tensor
from paddle1_tpu.distributed import ParallelEngine as JEngine
from paddle1_tpu.distributed import build_mesh as jbuild_mesh
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import async_loss
from paddle1_tpu_torch.core.async_loss import LossFuture, StepFuture
from paddle1_tpu_torch.core.errors import (InvalidArgumentError,
                                           UnimplementedError)
from paddle1_tpu_torch.distributed import ParallelEngine, build_mesh
from paddle1_tpu_torch.nn import TransformerEncoderLayer
from paddle1_tpu_torch.optimizer import AdamW
from paddle1_tpu_torch.optimizer import lr as tlr
from paddle1_tpu_torch.text.models import (BertForPretraining, BertModel,
                                           BertPretrainingCriterion)

CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=16, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
LR = 1e-3
TOL = dict(atol=1e-4, rtol=0)


def _batch(n=8, seq=16, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(1, vocab, (n, seq)).astype(np.int32),
            "mlm": rng.integers(0, vocab, (n, seq)).astype(np.int32),
            "nsp": rng.integers(0, 2, (n,)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_model():
    from paddle1_tpu.text.models import BertForPretraining as JBert
    from paddle1_tpu.text.models import BertModel as JBertModel
    from paddle1_tpu.text.models import BertPretrainingCriterion as JCrit
    paddle.seed(0)
    jm = JBert(JBertModel(**CFG))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    return jm, JCrit(64), state


def _jloss(jc, scaled=False):
    def loss_fn(m, b):
        s, r = m(Tensor(b["ids"]))
        loss = jc(s, r, Tensor(b["mlm"]), Tensor(b["nsp"]))
        return loss * Tensor(b["scale"]) if scaled else loss
    return loss_fn


def _tloss(scaled=False):
    crit = BertPretrainingCriterion(64)

    def loss_fn(m, b):
        s, r = m(b["ids"])
        loss = crit(s, r, b["mlm"], b["nsp"])
        return loss * b["scale"] if scaled else loss
    return loss_fn


def _jengine(jax_model, lr=LR, scaled=False, **kw):
    jm, jc, _ = jax_model
    return JEngine(jm, paddle.optimizer.AdamW(learning_rate=lr,
                                              parameters=jm.parameters()),
                   _jloss(jc, scaled),
                   mesh=jbuild_mesh(dp=1, devices=[jax.devices()[0]]), **kw)


def _tmodel(jax_model):
    tm = BertForPretraining(BertModel(device="cpu", **CFG))
    tm.load_state_dict(state_from_jax(jax_model[2], tm))
    return tm


def _tengine(jax_model, lr=LR, scaled=False, **kw):
    tm = _tmodel(jax_model)
    return ParallelEngine(tm, AdamW(learning_rate=lr,
                                    parameters=tm.parameters()),
                          _tloss(scaled), **kw)


def _assert_params_match(teng, jeng):
    jparams = {k: np.asarray(v) for k, v in jeng.params.items()}
    checked = 0
    for name, p in teng.model.state_dict().items():
        if name not in jparams:
            continue            # the tied alias: the JAX engine keeps one
        atol = 5 * LR if name.endswith("k_proj.bias") else 1e-4
        # the key bias's gradient is rounding noise in both packages (see
        # tests/test_torch_train.py), so it is held to steps x lr
        np.testing.assert_allclose(p.numpy(), jparams[name], atol=atol,
                                   rtol=0, err_msg=name)
        checked += 1
    assert checked == len(jparams) == 46


def _params(eng):
    return [p.detach().clone() for p in eng.params]


def test_constructor_takes_the_jax_parameters_in_the_jax_order():
    jsig = inspect.signature(JEngine.__init__).parameters
    tsig = inspect.signature(ParallelEngine.__init__).parameters
    assert list(tsig) == list(jsig)
    for name in jsig:
        assert tsig[name].default == jsig[name].default, name
    for meth in ("step", "step_many", "step_stream", "drain", "cache_stats",
                 "sync_model", "save_checkpoint", "load_checkpoint",
                 "shard_batch"):
        assert list(inspect.signature(getattr(ParallelEngine, meth))
                    .parameters) == list(inspect.signature(
                        getattr(JEngine, meth)).parameters)[:len(
                            inspect.signature(getattr(ParallelEngine, meth))
                            .parameters)], meth


def test_grad_accum_matches_jax(jax_model):
    b = _batch(n=16)
    acc = {k: v.reshape((2, 8) + v.shape[1:]) for k, v in b.items()}
    jeng = _jengine(jax_model, grad_accum=2)
    teng = _tengine(jax_model, grad_accum=2)
    jl = [float(jeng.step(acc)) for _ in range(3)]
    tl = [float(teng.step(acc)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    _assert_params_match(teng, jeng)
    # the accumulated step is the 16-row step's mean gradient: one step on
    # the whole batch lands on the same parameters
    whole = _tengine(jax_model)
    one = _tengine(jax_model, grad_accum=2)
    whole.step(b)
    one.step(acc)
    for p, q in zip(whole.params, one.params):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-6, rtol=0)
    with pytest.raises(InvalidArgumentError, match="grad_accum"):
        teng.step(b)
    # on config 4's one-card mesh (the dp arm: the micro-batches are cut
    # along their second axis, and each forward binds the dp group)
    meshed = _tengine(jax_model, grad_accum=2,
                      mesh=build_mesh(dp=1, sharding=1), zero_stage=2)
    assert meshed.shard_batch(acc).data["ids"].shape == (2, 8, 16)
    meshed.step(acc)
    for p, q in zip(one.params, meshed.params):
        assert torch.equal(p, q)


def test_clip_global_norm_clips_and_matches_jax(jax_model):
    b = _batch()
    probe = _tengine(jax_model)
    probe.step(b)
    raw = float(torch.sqrt(sum((g.double() ** 2).sum()
                               for g in probe._grads)))
    assert raw > 1.0                    # 0.1 really clips
    jeng = _jengine(jax_model, clip_global_norm=0.1)
    teng = _tengine(jax_model, clip_global_norm=0.1)
    jl = [float(jeng.step(b)) for _ in range(3)]
    tl = [float(teng.step(b)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_match(teng, jeng)
    clipped = float(torch.sqrt(sum((g.double() ** 2).sum()
                                   for g in teng._grads)))
    assert clipped == pytest.approx(0.1, rel=1e-4)


def test_check_finite_skips_a_poisoned_step_like_jax(jax_model):
    scales = [1.0, float("nan"), 1.0, 1.0]
    batches = [dict(_batch(seed=i), scale=np.float32(s))
               for i, s in enumerate(scales)]
    jeng = _jengine(jax_model, scaled=True, check_finite=True)
    teng = _tengine(jax_model, scaled=True, check_finite=True)
    jf = [jeng.step(bt) for bt in batches]
    tf = []
    for bt in batches:
        before = _params(teng)
        slots = {k: v.clone() for k, v in teng.optimizer.state_dict().items()
                 if k != "step"}
        tf.append(teng.step(bt))
        if np.isnan(bt["scale"]):
            for p, q in zip(before, teng.params):
                assert torch.equal(p, q.detach())
            for k, v in teng.optimizer.state_dict().items():
                if k != "step":
                    assert torch.equal(v, slots[k]), k
    assert all(isinstance(f, StepFuture) for f in tf)
    assert [f.bad for f in tf] == [f.bad for f in jf] == \
        [False, True, False, False]
    for f, g in zip(tf, jf):
        assert np.array_equal(f.bad_mask(), g.bad_mask())
        assert f.bad_count() == g.bad_count()
    assert np.isnan(float(tf[1])) and np.isnan(float(jf[1]))
    good = [0, 2, 3]
    np.testing.assert_allclose([float(tf[i]) for i in good],
                               [float(jf[i]) for i in good], **TOL)
    # the skipped step did not count: Adam's bias correction saw 3 steps
    assert teng.optimizer.state_dict()["step"] == 3 == \
        int(jeng.opt_state[1])
    _assert_params_match(teng, jeng)


def test_check_finite_under_step_many_masks_per_step(jax_model):
    scales = [1.0, float("nan"), 1.0]
    batches = [dict(_batch(seed=i), scale=np.float32(s))
               for i, s in enumerate(scales)]
    jeng = _jengine(jax_model, scaled=True, check_finite=True)
    teng = _tengine(jax_model, scaled=True, check_finite=True)
    jf, tf = jeng.step_many(batches), teng.step_many(batches)
    assert isinstance(tf, StepFuture)
    assert tf.bad_mask().tolist() == jf.bad_mask().tolist() == \
        [False, True, False]
    assert tf.bad and tf.bad_count() == 1
    np.testing.assert_allclose(np.asarray(tf)[[0, 2]],
                               np.asarray(jf)[[0, 2]], **TOL)
    _assert_params_match(teng, jeng)


def test_step_many_equals_steps_and_matches_jax(jax_model):
    batches = [_batch(seed=i) for i in range(3)]
    one = _tengine(jax_model)
    singles = [float(one.step(b)) for b in batches]
    many = _tengine(jax_model)
    fut = many.step_many(batches)
    assert isinstance(fut, LossFuture) and fut.tensor.shape == (3,)
    assert np.asarray(fut).tolist() == singles          # bit for bit
    for p, q in zip(one.params, many.params):
        assert torch.equal(p, q)
    assert many.dispatch_count == 1 and one.dispatch_count == 3
    jeng = _jengine(jax_model)
    np.testing.assert_allclose(np.asarray(fut),
                               np.asarray(jeng.step_many(batches)), **TOL)
    _assert_params_match(many, jeng)
    assert many.cache_stats() == jeng.cache_stats() == {"hits": 0,
                                                        "misses": 1}
    with pytest.raises(InvalidArgumentError, match=">= 1"):
        many.step_many([])


def test_step_stream_chunks_like_jax(jax_model):
    batches = [_batch(seed=i) for i in range(7)]
    jeng = _jengine(jax_model, train_steps_per_sync=3)
    teng = _tengine(jax_model, train_steps_per_sync=3)
    jf = list(jeng.step_stream(iter(batches)))
    tf = list(teng.step_stream(iter(batches)))
    assert [np.size(np.asarray(f)) for f in tf] == \
        [np.size(np.asarray(f)) for f in jf] == [3, 3, 1]
    np.testing.assert_allclose(np.concatenate([np.ravel(f) for f in tf]),
                               np.concatenate([np.ravel(f) for f in jf]),
                               **TOL)
    assert teng.dispatch_count == jeng.dispatch_count == 3
    assert teng.trace_count == jeng.trace_count == 2
    assert teng.cache_stats() == jeng.cache_stats()
    _assert_params_match(teng, jeng)


def test_trace_count_counts_new_shape_signatures(jax_model):
    teng = _tengine(jax_model)
    jeng = _jengine(jax_model)
    for n in (8, 8, 4, 8, 4):
        teng.step(_batch(n=n))
        jeng.step(_batch(n=n))
    assert teng.trace_count == jeng.trace_count == 2
    assert teng.cache_stats() == jeng.cache_stats() == {"hits": 3,
                                                        "misses": 2}


def test_recompute_gives_the_same_losses_and_reruns_each_block(jax_model):
    b = _batch()
    plain = _tengine(jax_model)
    remat = _tengine(jax_model, recompute=True)
    assert remat.model.bert.encoder.enable_recompute
    assert not plain.model.bert.encoder.enable_recompute
    calls = [0]

    def counted(fwd):
        def forward(*args, **kw):
            calls[0] += 1
            return fwd(*args, **kw)
        return forward
    for layer in remat.model.modules():
        if isinstance(layer, TransformerEncoderLayer):
            layer.forward = counted(layer.forward)
    lp = [float(plain.step(b)) for _ in range(3)]
    lr_ = [float(remat.step(b)) for _ in range(3)]
    # each block runs once forward and once more in the backward
    assert calls[0] == 3 * 2 * CFG["num_hidden_layers"]
    np.testing.assert_allclose(lr_, lp, atol=1e-6, rtol=0)
    for p, q in zip(plain.params, remat.params):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-6, rtol=0)
    jeng = _jengine(jax_model, recompute=True)
    np.testing.assert_allclose(lr_, [float(jeng.step(b)) for _ in range(3)],
                               **TOL)
    lin = torch.nn.Linear(4, 2)
    with pytest.warns(UserWarning, match="recompute"):
        ParallelEngine(lin, AdamW(), lambda m, bt: m(bt).sum(),
                       recompute=True)


def test_scheduled_learning_rate_through_the_engine(jax_model):
    def sched(mod):
        return mod.LinearWarmup(mod.PolynomialDecay(LR, 4, end_lr=1e-5),
                                warmup_steps=2, start_lr=0.0, end_lr=LR)
    b = _batch()
    jeng = _jengine(jax_model, lr=sched(paddle.optimizer.lr))
    teng = _tengine(jax_model, lr=sched(tlr))
    jl = [float(jeng.step(b)) for _ in range(4)]
    tl = [float(teng.step(b)) for _ in range(4)]
    # step 0 runs at lr 0: the second loss equals the first
    assert tl[1] == pytest.approx(tl[0], abs=1e-7)
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_params_match(teng, jeng)
    s = teng.optimizer._learning_rate
    assert s.last_epoch == jeng.optimizer._learning_rate.last_epoch == 4
    assert teng.optimizer.get_lr() == jeng.optimizer.get_lr()
    # step_many advances the schedule k times
    teng.step_many([b, b, b])
    assert s.last_epoch == 7


def test_zero_stage_on_a_one_card_mesh_is_the_identity(jax_model):
    b = _batch()
    ref = _tengine(jax_model)
    lr_ = [float(ref.step(b)) for _ in range(2)]
    for stage in (0, 1, 2, 3):
        eng = _tengine(jax_model, mesh=build_mesh(dp=1, sharding=1),
                       zero_stage=stage)
        assert eng._flat is not None    # the dp arm: one flat buffer
        assert [float(eng.step(b)) for _ in range(2)] == lr_
    with pytest.raises(InvalidArgumentError, match="zero_stage"):
        _tengine(jax_model, zero_stage=4)


def test_unported_options_and_checkpoints_raise(jax_model, tmp_path):
    """What stays unported raises. Checkpoints are ported (ROADMAP item
    6's first part): a save and a load into a fresh engine give the same
    next step. So are pipeline and sequence parallelism: without pp the
    micro-batch count changes nothing (the JAX engine's rule), a
    batch_spec cuts the batch axis, and one that cuts the sequence over
    sp is the identity without an sp axis (item 5(iv-b))."""
    b = _batch()
    teng = _tengine(jax_model, donate=True)
    teng.step(b)
    path = teng.save_checkpoint(str(tmp_path / "ck"))
    again = _tengine(jax_model)
    again.load_checkpoint(path)
    assert float(again.step(b)) == float(teng.step(b))
    _tengine(jax_model, pp_microbatches=2, batch_spec=("dp",))
    assert float(_tengine(jax_model, batch_spec=(None, "sp")).step(b)) == \
        float(_tengine(jax_model).step(b))
    with pytest.raises(InvalidArgumentError, match="grad_accum"):
        _tengine(jax_model, grad_accum=0)


def test_inflight_window_drain_and_readbacks(jax_model):
    b = _batch()
    teng = _tengine(jax_model, inflight_window=2)
    async_loss.reset_readback_count()
    futs = [teng.step(b) for _ in range(4)]
    assert len(teng._inflight) == 2 and async_loss.readback_count() == 0
    teng.drain()
    teng.sync_model()
    assert len(teng._inflight) == 0 and async_loss.readback_count() == 0
    first = float(futs[0])
    assert float(futs[0]) == first and futs[0] > 0 and futs[0].materialized
    assert async_loss.readback_count() == 1
    assert f"{futs[1]:.3f}" == f"{float(futs[1]):.3f}"
    assert async_loss.readback_count() == 2
    seen = []
    async_loss.set_readback_observer(seen.append)
    try:
        float(futs[2])
    finally:
        async_loss.set_readback_observer(None)
    assert len(seen) == 1 and seen[0] >= 0.0
    assert futs[3].block() is futs[3] and not futs[3].materialized


def test_step_future_reads_back_once():
    async_loss.reset_readback_count()
    fut = StepFuture(torch.tensor([[1.5, 0.0], [float("nan"), 1.0]]))
    assert fut.bad_mask().tolist() == [False, True]
    assert fut.bad and fut.bad_count() == 1
    assert np.asarray(fut)[0] == 1.5 and len(fut) == 2
    assert async_loss.readback_count() == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert float(StepFuture(torch.tensor([2.0, 0.0]))) == 2.0


def _encoder_layer(seed=0):
    torch.manual_seed(seed)
    return TransformerEncoderLayer(16, 2, 32, dropout=0.0, device="cpu")


@pytest.mark.parametrize("form", ["layer", "bound", "sequential"])
def test_recompute_forms_give_the_plain_gradients(form):
    from paddle1_tpu_torch.distributed.fleet.utils import (
        recompute, recompute_sequential)
    layers = [_encoder_layer(0), _encoder_layer(1)]
    x0 = torch.randn(2, 8, 16)

    def run(remat):
        x = x0.clone().requires_grad_()
        if not remat:
            y = layers[1](layers[0](x))
        elif form == "layer":
            y = recompute(layers[1], recompute(layers[0], x))
        elif form == "bound":
            y = recompute(layers[1].forward, recompute(layers[0].forward, x))
        else:
            y = recompute_sequential({"segments": 2}, layers, x)
        params = [p for m in layers for p in m.parameters()]
        return [y] + list(torch.autograd.grad(y.square().sum(),
                                              [x] + params))
    for a, b in zip(run(False), run(True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_recompute_of_an_opaque_callable_warns_and_keeps_gradients():
    from paddle1_tpu_torch.distributed.fleet.utils import recompute
    layer = _encoder_layer()
    x = torch.randn(2, 8, 16, requires_grad=True)
    with pytest.warns(UserWarning, match="opaque callable"):
        y = recompute(lambda t: layer(t) * 2.0, x)
    g, = torch.autograd.grad(y.sum(), [x])
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    with pytest.raises(TypeError, match="unexpected"):
        recompute(layer, x, bogus=1)
