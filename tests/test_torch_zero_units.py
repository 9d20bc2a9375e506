"""Item 5(v) of the PyTorch port against the JAX package, on the CPU:
ZeRO's memory scaling in ``ParallelEngine``. The trained tensors fall
into units (each encoder block, and the root unit of everything else);
each unit's gradient is reduced as the backward completes it (stage 1:
all-reduced; stages 2-3: reduce-scattered into the rank's shard and
freed, so no whole-model gradient buffer exists), and stage 3 gathers a
unit's parameters only around its forward and its backward.

The multi-rank cases run in gloo ranks that the port's ``spawn`` starts
(``tests/test_torch_zero_seq_ranks.py`` holds their side): sharding 2 on
two ranks, dp 2 x sharding 2 on four, at ZeRO 1, 2 and 3, each with
``grad_accum=2``, ``clip_global_norm`` and ``check_finite``; the JAX
engine runs the same meshes on the virtual 8-device CPU mesh of
``tests/conftest.py``. The memory claims are read from the engine's own
counters (``_zero``'s units and high-water marks), not from a public API.
"""

import os

import jax
import numpy as np
import pytest

import paddle1_tpu as paddle
import test_torch_zero_seq_ranks as ranks
from paddle1_tpu.core.tensor import Tensor
from paddle1_tpu_torch import distributed as tdist

JOB_TIMEOUT_S = 300
# three AdamW steps of the tiny BERT, each the mean of two micro-batches,
# clipped: f32 sums in another order on each side, compounded
TOL = 1e-4
KEY_BIAS_TOL = ranks.STEPS * ranks.LR
MESHES = ranks.ZERO_MESHES_2 + ranks.ZERO_MESHES_4
BLOCKS = ranks.BERT["num_hidden_layers"]


def _batch(n=16, seq=16, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(1, vocab, (n, seq)).astype(np.int32),
            "mlm": rng.integers(0, vocab, (n, seq)).astype(np.int32),
            "nsp": rng.integers(0, 2, (n,)).astype(np.int32)}


def _load(out, case, n):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in range(n)]


@pytest.fixture(scope="module")
def bert_case(tmp_path_factory):
    from paddle1_tpu.text.models import BertForPretraining, BertModel
    tmp = tmp_path_factory.mktemp("bert")
    paddle.seed(0)
    jm = BertForPretraining(BertModel(**ranks.BERT))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    np.savez(tmp / "state.npz", **state)
    np.savez(tmp / "batch.npz", **_batch())
    return {"dir": tmp, "state": state}


def _run_job(tmp, n, cases):
    tdist.spawn(ranks.job, args=(str(tmp), str(tmp / f"store{n}"), cases),
                nprocs=n, timeout=JOB_TIMEOUT_S)
    return str(tmp)


@pytest.fixture(scope="module")
def job2(tmp_path_factory, bert_case):
    d = bert_case["dir"]
    files = (str(d / "state.npz"), str(d / "batch.npz"))
    return _run_job(tmp_path_factory.mktemp("job2"), 2, [
        ("zero", files + (ranks.ZERO_MESHES_2 + ranks.ZERO_AMP_2,))])


@pytest.fixture(scope="module")
def job4(tmp_path_factory, bert_case):
    d = bert_case["dir"]
    files = (str(d / "state.npz"), str(d / "batch.npz"))
    return _run_job(tmp_path_factory.mktemp("job4"), 4, [
        ("zero", files + (ranks.ZERO_MESHES_4,))])


def _mesh(name):
    return [m for m in MESHES if m[0] == name][0]


def _out(name, job2, job4):
    n = 2 if name.startswith("sh2") else 4
    return _load(job2 if n == 2 else job4, name, n)


def _jax_run(state, degrees, kw, batch):
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh as jbuild
    from paddle1_tpu.text.models import (BertForPretraining, BertModel,
                                         BertPretrainingCriterion,
                                         apply_megatron_sharding)
    jm = BertForPretraining(BertModel(**ranks.BERT))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    apply_megatron_sharding(jm)
    crit = BertPretrainingCriterion(ranks.BERT["vocab_size"])

    def loss_fn(m, b):
        s, rel = m(Tensor(b["ids"]))
        return crit(s, rel, Tensor(b["mlm"]), Tensor(b["nsp"]))
    n = int(np.prod(list(degrees.values())))
    eng = JEngine(jm, paddle.optimizer.AdamW(learning_rate=ranks.LR,
                                             parameters=jm.parameters()),
                  loss_fn, mesh=jbuild(devices=jax.devices()[:n], **degrees),
                  **kw)
    losses = [float(eng.step(batch)) for _ in range(ranks.STEPS)]
    eng.sync_model()
    return losses, {k: np.asarray(v) for k, v in eng.params.items()}


@pytest.fixture(scope="module")
def ws1(bert_case):
    """The port at world size 1 with the same controls."""
    from paddle1_tpu_torch.optimizer import AdamW
    tm = ranks.bert(str(bert_case["dir"] / "state.npz"))
    eng = tdist.ParallelEngine(tm, AdamW(learning_rate=ranks.LR,
                                         parameters=tm.parameters()),
                               ranks.bert_loss(), **ranks.ZERO_KW)
    b = ranks.batch_of(str(bert_case["dir"] / "batch.npz"), ranks.ZERO_KW)
    losses = [float(eng.step(b)) for _ in range(ranks.STEPS)]
    return losses, {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def _close(got, want, what):
    for k, v in want.items():
        if k not in got:
            continue          # the tied alias: the JAX engine keeps one
        tol = KEY_BIAS_TOL if k.endswith("k_proj.bias") else TOL
        np.testing.assert_allclose(got[k], np.asarray(v), atol=tol, rtol=0,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_zero_units_match_the_jax_engine_and_world_size_1(
        mesh, job2, job4, bert_case, ws1):
    """Three steps of two micro-batches each, clipped and checked for
    finiteness, at ZeRO 1-3 on sharding 2 and dp 2 x sharding 2: every
    rank's losses and rank 0's whole state within 1e-4 of the JAX engine
    on the same mesh and of world size 1."""
    _, degrees, kw = _mesh(mesh)
    out = _out(mesh, job2, job4)
    state = {k[len("state."):]: v for k, v in out[0].items()
             if k.startswith("state.")}
    jl, jp = _jax_run(bert_case["state"], degrees, kw,
                      ranks.batch_of(str(bert_case["dir"] / "batch.npz"),
                                     kw))
    tl, tp = ws1
    for got in out:
        np.testing.assert_allclose(got["losses"], jl, atol=TOL, rtol=0)
        np.testing.assert_allclose(got["losses"], tl, atol=TOL, rtol=0)
    _close(state, jp, "against the JAX engine")
    _close(state, tp, "against world size 1")
    assert set(state) == set(tp)


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_no_whole_gradient_and_one_unit_gathered_at_a_time(mesh, job2,
                                                           job4):
    """The engine's counters: one unit a block and the root unit; at
    stages 2-3 no gradient buffer of the whole model's size (no flat
    buffer; the largest gradient ever assembled is one unit's); at stage 3
    the largest buffer ever gathered is one unit (f32 here), and at most
    the root unit and two blocks are whole at once (a block's backward
    gathers the one before it as it ends); stage 1 keeps the whole
    gradient, by definition, and assembles nothing else. A step makes one
    reduce-scatter a unit a micro-batch at stages 2-3, and all-gathers a
    unit at a time (stage 3: the root unit once, each block before its
    forward and its backward, each micro-batch)."""
    _, _, kw = _mesh(mesh)
    stage, accum = kw["zero_stage"], kw["grad_accum"]
    for got in _out(mesh, job2, job4):
        units = [int(n) for n in got["units"]]
        assert len(units) == 1 + BLOCKS
        root, block = units[0], max(units[1:])
        if stage == 1:
            assert bool(got["whole_grad_buffer"]) is False
            assert int(got["max_grad_buffer"]) == 0
        else:
            assert bool(got["whole_grad_buffer"]) is False
            assert int(got["max_grad_buffer"]) == max(units) < sum(units)
            assert int(got["calls_reduce_scatter"]) == len(units) * accum
        if stage == 3:
            assert int(got["max_unit_gathered"]) == 4 * max(units)
            assert int(got["max_gathered"]) <= 4 * (root + 2 * block)
            assert int(got["calls_all_gather"]) == 1 + 2 * BLOCKS * accum
        else:
            assert int(got["max_gathered"]) == 0
            assert int(got["calls_all_gather"]) == len(units)


def test_bf16_stage_3_takes_stage_2s_step(job2):
    """Under ``amp_dtype="bfloat16"`` stage 3 gathers each unit's 16-bit
    leaves after the cast, stage 2 casts the whole parameters: the same
    values, so the same steps, bit for bit; stage 3's largest gather is a
    16-bit unit."""
    z2 = _load(job2, "sh2_z2_bf16", 2)
    z3 = _load(job2, "sh2_z3_bf16", 2)
    for a, b in zip(z2, z3):
        assert a["losses"].tolist() == b["losses"].tolist()
        assert int(b["max_unit_gathered"]) == 2 * max(b["units"])
    for k, v in z2[0].items():
        if k.startswith("state."):
            np.testing.assert_array_equal(v, z3[0][k], err_msg=k)
