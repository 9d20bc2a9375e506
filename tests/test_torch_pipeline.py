"""Slice 4b(iii) of the PyTorch port against the JAX package, in one
process on the CPU: ``SegmentLayers`` and ``PipelineLayer``'s partitions,
``PipelineParallel``'s 1F1B ``train_batch`` on heterogeneous stages (its
in-flight bound, an integer and a tuple boundary), ``stack_stage_params``
and ``pipeline_apply`` on one stage, the encoder's pipelined forward on
one stage, and the engine's ``batch_spec`` and pipeline options.

The multi-rank pipeline (the engine at ``pp > 1``, ``pipeline_apply`` on
four stages, ``fleet`` at ``pp_degree`` 2) is
``tests/test_torch_pipeline_engine.py``. Weights are carried from the
JAX package's state dicts; everything is float32 and each tolerance is
stated where it is used.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.core.tensor import to_tensor
from paddle1_tpu_torch import distributed as tdist
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.errors import (InvalidArgumentError,
                                           UnimplementedError)
from paddle1_tpu_torch.distributed.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, SegmentLayers,
    SharedLayerDesc)
from paddle1_tpu_torch.utils import unique_name

# tests/test_pipeline_v2.py's tolerances for 1F1B against sequential
# accumulation
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-6
VOCAB, HIDDEN, BLOCKS, CLASSES = 64, 16, 4, 4


class _HCG:
    """A hybrid group of one data-parallel rank (the JAX tests' stub)."""

    def get_data_parallel_group(self):
        return tdist.Group(0, 1)


class _Strategy:
    def __init__(self, accumulate_steps, micro_batch_size):
        self.pipeline_configs = {"accumulate_steps": accumulate_steps,
                                 "micro_batch_size": micro_batch_size}


def _jax_descs():
    from paddle1_tpu.nn.layer_common import Embedding, Linear
    from paddle1_tpu.ops import math_ops

    def mean_pool(x):
        return math_ops.mean(x, axis=1)
    return ([Embedding(VOCAB, HIDDEN)] +
            [Linear(HIDDEN, HIDDEN) for _ in range(BLOCKS)] +
            [mean_pool, Linear(HIDDEN, CLASSES)])


def _port_descs():
    from paddle1_tpu_torch.nn import Embedding, Linear

    def mean_pool(x):
        return torch.mean(x, dim=1)
    with unique_name.guard():
        return ([Embedding(VOCAB, HIDDEN, device="cpu")] +
                [Linear(HIDDEN, HIDDEN, device="cpu")
                 for _ in range(BLOCKS)] +
                [mean_pool, Linear(HIDDEN, CLASSES, device="cpu")])


def _port_loss(out, y):
    from paddle1_tpu_torch.nn import functional as F
    return F.cross_entropy(out, torch.as_tensor(y))


def _jax_loss(out, y):
    return paddle.nn.functional.cross_entropy(out, to_tensor(y))


def _models(stages, seed=0):
    """The JAX package's heterogeneous PipelineLayer of
    tests/test_pipeline_v2.py and the port's, with the JAX weights."""
    from paddle1_tpu.distributed.meta_parallel.pp_layers import \
        PipelineLayer as JPipelineLayer
    np.random.seed(seed)
    paddle.seed(seed)
    jm = JPipelineLayer(_jax_descs(), num_stages=stages, loss_fn=_jax_loss)
    tm = PipelineLayer(_port_descs(), num_stages=stages, loss_fn=_port_loss)
    state = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_from_jax(state, tm))
    return jm, tm


# ---------------------------------------------------------------------------
# (a) partitions


@pytest.mark.parametrize("method", ["uniform", "parameters", "layer:Linear"])
@pytest.mark.parametrize("parts", [1, 2, 3, 4, 5])
def test_segment_layers_equal_the_jax_packages(method, parts):
    from paddle1_tpu.distributed.meta_parallel.pp_layers import (
        LayerDesc as JLayerDesc, SegmentLayers as JSegmentLayers)
    from paddle1_tpu.nn.layer_common import (Embedding as JEmbedding,
                                             Linear as JLinear)
    from paddle1_tpu_torch.nn import Embedding, Linear
    shapes = [(VOCAB, HIDDEN)] + [(HIDDEN, HIDDEN)] * BLOCKS + \
        [(HIDDEN, CLASSES)]
    jd = [JLayerDesc(JEmbedding, *shapes[0])] + \
        [JLayerDesc(JLinear, *s) for s in shapes[1:]]
    td = [LayerDesc(Embedding, *shapes[0], device="cpu")] + \
        [LayerDesc(Linear, *s, device="cpu") for s in shapes[1:]]
    want, got = None, None
    try:
        want = JSegmentLayers(jd, parts, method).do_segment()
    except Exception as e:   # noqa: BLE001 (the refusal is compared)
        want = type(e).__name__
    try:
        got = SegmentLayers(td, parts, method).do_segment()
    except InvalidArgumentError as e:
        got = type(e).__name__
    assert got == want


def test_pipeline_layer_partition_tags_and_shared_layers():
    """``segment_parts``, ``get_stage_from_index`` and ``stage_layers``
    equal the JAX package's; every parameter carries its ``pp_stage``; a
    ``SharedLayerDesc`` named twice builds one layer; an unknown method
    and too many stages raise."""
    from paddle1_tpu_torch.nn import Linear
    jm, tm = _models(4)
    assert tm.segment_parts == jm.segment_parts
    assert tm.num_stages == jm.num_stages == 4
    n = len(tm.run_function)
    assert [tm.get_stage_from_index(i) for i in range(n)] == \
        [jm.get_stage_from_index(i) for i in range(n)]
    for s in range(4):
        assert len(tm.stage_layers(s)) == len(jm.stage_layers(s))
        for lyr in tm.stage_layers(s):
            assert all(p.pp_stage == s for p in lyr.parameters())
    with unique_name.guard():
        shared = SharedLayerDesc("tied", Linear, None, "weight", 4, 4,
                                 device="cpu")
        layer = PipelineLayer([shared, LayerDesc(Linear, 4, 4, device="cpu"),
                               shared], num_stages=2)
    assert layer.run_function[0] is layer.run_function[2]
    assert len(list(layer.parameters())) == 4
    with pytest.raises(InvalidArgumentError, match="Unknown segment"):
        SegmentLayers([1, 2], 1, "nope").do_segment()
    with pytest.raises(InvalidArgumentError, match="cannot fill"):
        SegmentLayers([1, 2], 3)


# ---------------------------------------------------------------------------
# (b) PipelineParallel's 1F1B schedule


def _train_batch(model, x, y, stages_micro, lr=0.1):
    from paddle1_tpu_torch.optimizer import SGD
    acc, micro = stages_micro
    runner = PipelineParallel(model, _HCG(), strategy=_Strategy(acc, micro))
    opt = SGD(learning_rate=lr, parameters=model.parameters())
    return runner, runner.train_batch([torch.as_tensor(x), y], opt)


def test_1f1b_train_batch_matches_the_jax_package_and_sequential():
    """tests/test_pipeline_v2.py:160-209 in both packages: four
    heterogeneous stages, four micro-batches of two, one SGD step; the
    port's loss and parameters equal the JAX package's and the port's own
    sequential accumulation."""
    from paddle1_tpu.distributed.meta_parallel.pipeline_parallel import \
        PipelineParallel as JPipelineParallel
    from paddle1_tpu.distributed.collective import Group as JGroup
    from paddle1_tpu_torch.optimizer import SGD
    rng = np.random.default_rng(0)
    x = rng.integers(0, VOCAB, (8, 6)).astype(np.int64)
    y = rng.integers(0, CLASSES, (8,)).astype(np.int64)
    jm, tm = _models(4)
    _, seq = _models(4)

    class _JHCG:
        def get_data_parallel_group(self):
            return JGroup(0, 1)
    strat = paddle.distributed.fleet.DistributedStrategy()
    strat.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}
    jrun = JPipelineParallel(jm, _JHCG(), strategy=strat)
    jloss = jrun.train_batch([to_tensor(x), y], paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jm.parameters()))
    _, loss = _train_batch(tm, x, y, (4, 2))
    opt = SGD(learning_rate=0.1, parameters=seq.parameters())
    total = 0.0
    for i in range(4):
        li = _port_loss(seq(torch.as_tensor(x[i * 2:(i + 1) * 2])),
                        y[i * 2:(i + 1) * 2])
        (li / 4.0).backward()
        total = total + li.detach()
    opt.step()
    np.testing.assert_allclose(float(loss), float(jloss.numpy()),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), float(total / 4.0),
                               rtol=LOSS_RTOL)
    jstate = {k: np.asarray(v.data) for k, v in jm.state_dict().items()}
    sstate = seq.state_dict()
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.detach(), jstate[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(v.detach(), sstate[k].detach(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_1f1b_in_flight_bound():
    """Stage s holds at most S - s micro-batches, and stage 0 reaches its
    bound (tests/test_pipeline_v2.py:211-240)."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, VOCAB, (16, 6)).astype(np.int64)
    y = rng.integers(0, CLASSES, (16,)).astype(np.int64)
    _, tm = _models(4, seed=1)
    runner, loss = _train_batch(tm, x, y, (8, 2))
    assert np.isfinite(float(loss))
    assert all(runner.last_max_in_flight[s] <= 4 - s for s in range(4))
    assert runner.last_max_in_flight[0] == 4


def test_1f1b_integer_and_tuple_boundaries():
    """An integer boundary (stage 0 the identity over the ids) hands None
    upstream and does not deadlock, and the embedding behind it trains;
    a tuple boundary carries both gradients back (both as in
    tests/test_pipeline_v2.py:242-351, against sequential accumulation
    for the tuple)."""
    from paddle1_tpu_torch.nn import Embedding, Linear
    from paddle1_tpu_torch.optimizer import SGD
    with unique_name.guard():
        emb = Embedding(32, 8, device="cpu")
        before = emb.weight.detach().clone()
        model = PipelineLayer([lambda t: t, emb,
                               lambda t: torch.mean(t, dim=1),
                               Linear(8, 4, device="cpu")], num_stages=2,
                              loss_fn=_port_loss)
    rng = np.random.default_rng(3)
    x = rng.integers(0, 32, (4, 5)).astype(np.int64)
    y = rng.integers(0, 4, (4,)).astype(np.int64)
    _, loss = _train_batch(model, x, y, (2, 2))
    assert np.isfinite(float(loss))
    assert not torch.equal(emb.weight.detach(), before)

    def descs():
        with unique_name.guard():
            gen = torch.Generator().manual_seed(5)
            return [Embedding(32, 8, device="cpu", generator=gen),
                    lambda t: (t, t * 2.0),
                    lambda a, b: torch.mean(a + b, dim=1),
                    Linear(8, 4, device="cpu", generator=gen)]
    piped = PipelineLayer(descs(), num_stages=2, loss_fn=_port_loss)
    seq = PipelineLayer(descs(), num_stages=2, loss_fn=_port_loss)
    _, loss = _train_batch(piped, x, y, (2, 2))
    opt = SGD(learning_rate=0.1, parameters=seq.parameters())
    total = 0.0
    for i in range(2):
        li = _port_loss(seq(torch.as_tensor(x[i * 2:(i + 1) * 2])),
                        y[i * 2:(i + 1) * 2])
        (li / 2.0).backward()
        total = total + li.detach()
    opt.step()
    np.testing.assert_allclose(float(loss), float(total / 2.0),
                               rtol=LOSS_RTOL)
    for (k, v), w in zip(piped.state_dict().items(),
                         seq.state_dict().values()):
        np.testing.assert_allclose(v.detach(), w.detach(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_train_batch_refusals_and_eval_batch():
    _, tm = _models(2)
    with pytest.raises(InvalidArgumentError, match="PipelineLayer"):
        PipelineParallel(torch.nn.Linear(2, 2), _HCG())
    x = np.zeros((6, 6), np.int64)
    with pytest.raises(InvalidArgumentError, match="divisible"):
        _train_batch(tm, x, np.zeros(6, np.int64), (2, 4))
    runner = PipelineParallel(tm, _HCG(), strategy=_Strategy(2, 2))
    out = runner.eval_batch([torch.as_tensor(x), np.zeros(6, np.int64)],
                            compute_loss=False)
    assert tuple(out.shape) == (6, CLASSES)


# ---------------------------------------------------------------------------
# (c) stack_stage_params and pipeline_apply on one stage


def test_stack_stage_params_equals_the_jax_packages():
    from paddle1_tpu.distributed.pipeline import \
        stack_stage_params as jstack
    rng = np.random.default_rng(2)
    per = [{"w": rng.standard_normal((3, 2)).astype(np.float32),
            "n": [rng.standard_normal(4).astype(np.float32)]}
           for _ in range(3)]
    got = tdist.stack_stage_params(
        [{"w": torch.from_numpy(p["w"]), "n": [torch.from_numpy(p["n"][0])]}
         for p in per])
    want = jstack(per)
    np.testing.assert_array_equal(got["w"], np.asarray(want["w"]))
    np.testing.assert_array_equal(got["n"][0], np.asarray(want["n"][0]))


def test_pipeline_apply_on_one_stage_is_the_stage_and_checks_its_input():
    """Without a pp group there is one stage: its outputs and gradients
    are the stage function's over every micro-batch; a stacked stage
    count that is neither 1 nor the group's raises, and so does a stage
    that changes the shape."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((1, 5, 5)).astype(np.float32))
    w.requires_grad_()
    x = torch.from_numpy(rng.standard_normal((3, 2, 5)).astype(np.float32))
    x.requires_grad_()
    y = tdist.pipeline_apply(lambda p, t: torch.tanh(t @ p["w"]),
                             {"w": w}, x)
    y.square().sum().backward()
    w2, x2 = w.detach().clone().requires_grad_(), \
        x.detach().clone().requires_grad_()
    torch.tanh(x2 @ w2[0]).square().sum().backward()
    np.testing.assert_allclose(y.detach(), torch.tanh(x2 @ w2[0]).detach(),
                               atol=1e-6)
    np.testing.assert_allclose(w.grad, w2.grad, atol=1e-6)
    np.testing.assert_allclose(x.grad, x2.grad, atol=1e-6)
    with pytest.raises(InvalidArgumentError, match="stacked stage count"):
        tdist.pipeline_apply(lambda p, t: t, {"w": torch.zeros(3, 2)}, x)
    with pytest.raises(InvalidArgumentError, match="keep its input"):
        tdist.pipeline_apply(lambda p, t: t[:, :1], {"w": w}, x)


# ---------------------------------------------------------------------------
# (d) the encoder's pipelined forward, on one stage


def _encoder():
    from paddle1_tpu_torch.nn import (TransformerEncoder,
                                      TransformerEncoderLayer)
    with unique_name.guard():
        gen = torch.Generator().manual_seed(6)
        layer = TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                        device="cpu", generator=gen)
        return TransformerEncoder(layer, 4)


@pytest.mark.parametrize("mask", ["causal", "padding", "none"])
def test_pipelined_encoder_on_one_stage_equals_the_block_stack(mask):
    """The encoder tagged with a one-rank pp group, inside its ``pp``
    binding, runs its blocks through ``run_pipeline`` in two
    micro-batches: outputs and gradients equal the sequential stack's
    (tests/test_pipeline_v2.py:283-307's broadcastable causal mask, a
    per-example mask cut with the micro-batches, no mask); a batch the
    micro-batches do not divide raises."""
    from paddle1_tpu_torch.distributed import env
    enc = _encoder()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    m = {"causal": torch.tril(torch.ones(8, 8, dtype=torch.bool))[None, None],
         "padding": torch.from_numpy(rng.random((4, 1, 1, 8)) > 0.3),
         "none": None}[mask]
    xs = x.clone().requires_grad_()
    want = enc(xs, m)
    want.square().sum().backward()
    grads = {k: p.grad.clone() for k, p in enc.named_parameters()}
    enc.zero_grad()
    group = tdist.Group(0, 1, axis="pp")
    enc.pipeline_group, enc.pipeline_microbatches = group, 2
    xp = x.clone().requires_grad_()
    with env.spmd_axes(pp=group):
        got = enc(xp, m)
        got.square().sum().backward()
        with pytest.raises(InvalidArgumentError, match="microbatches"):
            enc(x[:3], None if mask != "causal" else m)
    np.testing.assert_allclose(got.detach(), want.detach(), atol=1e-5)
    np.testing.assert_allclose(xp.grad, xs.grad, atol=1e-5)
    for k, p in enc.named_parameters():
        np.testing.assert_allclose(p.grad, grads[k], atol=1e-5, err_msg=k)
    # outside the engine's binding the tagged encoder runs its stack
    np.testing.assert_allclose(enc(x, m).detach(), want.detach(), atol=1e-6)


# ---------------------------------------------------------------------------
# (e) the engine's batch_spec and pipeline options at world size 1


def _engine(**kw):
    from paddle1_tpu_torch.optimizer import SGD
    from paddle1_tpu_torch.text.models import (BertForPretraining,
                                               BertModel,
                                               BertPretrainingCriterion)
    with unique_name.guard():
        gen = torch.Generator().manual_seed(8)
        m = BertForPretraining(BertModel(
            vocab_size=64, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=16, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, device="cpu", generator=gen),
            generator=gen)
    crit = BertPretrainingCriterion(64)

    def loss_fn(mm, b):
        s, r = mm(b["ids"])
        return crit(s, r, b["mlm"], b["nsp"])
    return tdist.ParallelEngine(m, SGD(learning_rate=0.1,
                                       parameters=m.parameters()),
                                loss_fn, **kw)


def test_batch_spec_cuts_the_batch_axis_and_refuses_the_sequence():
    """The JAX form: ``("dp",)`` and ``(("dp", "sharding"), None)`` cut the
    leading axis over the data axes, and train as the default does; a
    spec that cuts the sequence over sp (ROADMAP item 5(iv-b), ported)
    trains the same at world size 1, where there is no sp axis; one that
    cuts the batch over an axis that is not a data axis raises, as does
    one that cuts the sequence over another axis than sp; an unknown axis
    or entry raises."""
    rng = np.random.default_rng(9)
    b = {"ids": rng.integers(1, 64, (4, 8)).astype(np.int32),
         "mlm": rng.integers(0, 64, (4, 8)).astype(np.int32),
         "nsp": rng.integers(0, 2, (4,)).astype(np.int32)}
    want = [float(_engine().step(b)) for _ in range(1)]
    for spec in (("dp",), (("dp", "sharding"), None), "dp", (None, "sp"),
                 (("dp", "sharding"), "sp")):
        eng = _engine(batch_spec=spec)
        assert eng.batch_spec == spec
        assert [float(eng.step(b))] == want
    for spec in (("mp",), ("sp",), (None, "mp"), (None, None, "sp")):
        with pytest.raises(UnimplementedError, match="data axes"):
            _engine(batch_spec=spec)
    with pytest.raises(InvalidArgumentError, match="not a mesh axis"):
        _engine(batch_spec=("data",))
    with pytest.raises(InvalidArgumentError, match="batch_spec entry"):
        _engine(batch_spec=(3,))


def test_pp_microbatches_without_pp_and_stale_pipeline_tags():
    """Without pp the micro-batch count changes nothing (the JAX engine's
    rule), and an engine at pp 1 clears the tags a pipelined engine left
    on the model's encoders."""
    eng = _engine(pp_microbatches=2)
    encs = [m for m in eng.model.modules()
            if hasattr(m, "pipeline_group")]
    assert encs and all(e.pipeline_group is None and
                        e.pipeline_microbatches is None for e in encs)
    encs[0].pipeline_group = tdist.Group(0, 1, axis="pp")
    tdist.ParallelEngine(eng.model, eng.optimizer, eng.loss_fn)
    assert encs[0].pipeline_group is None
