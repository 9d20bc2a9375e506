"""Slice 4b(iii) of the PyTorch port on gloo ranks on the CPU:
``ParallelEngine`` at ``pp > 1`` (and ``sp > 1``) against the JAX engine
on the same meshes and against the port at world size 1,
``pipeline_apply`` on four stages, ``sync_model`` gathering the stages,
``fleet`` at ``pp_degree`` 2, and ``chip_smoke``'s phase-46 check holding
at every mesh and failing every planted fault.

The ranks run in jobs that the port's ``spawn`` starts
(``tests/test_torch_pipeline_ranks.py`` holds their side): one 4-rank and
one 2-rank job, each rank joined through a ``FileStore`` under the test's
temporary directory, single-threaded, with a hard timeout. The JAX engine
runs the same meshes on the virtual 8-device CPU mesh of
``tests/conftest.py`` (``devices=`` its first four). The model is the
tiny BERT of ``tests/test_pipeline_v2.py`` (four blocks, dropout off),
trained with SGD; everything is float32 and each tolerance is stated
where it is used.
"""

import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle1_tpu as paddle
import test_torch_pipeline_ranks as ranks
from paddle1_tpu.core.tensor import Tensor
from paddle1_tpu_torch import distributed as tdist

JOB_TIMEOUT_S = 300
# three SGD steps of the tiny BERT, f32 sums in another order on each side
# (tests/test_pipeline_v2.py holds pp 4 to pp 1 at rtol 2e-4)
JAX_TOL = 2e-4
WS1_TOL = 1e-4


def _load(out, case, n):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in range(n)]


def _batch(n=8, seq=16, vocab=128, seed=0):
    rng = np.random.default_rng(seed)   # tests/test_pipeline_v2.py's
    return {"ids": rng.integers(1, vocab, (n, seq)).astype(np.int32),
            "mlm": rng.integers(0, vocab, (n, seq)).astype(np.int32),
            "nsp": rng.integers(0, 2, (n,)).astype(np.int32)}


@pytest.fixture(scope="module")
def bert_case(tmp_path_factory):
    """The tiny BERT's JAX weights and the global batches (8 rows; 16 as
    [2, 8] under grad_accum), saved for the ranks."""
    from paddle1_tpu.text.models import BertForPretraining, BertModel
    tmp = tmp_path_factory.mktemp("ppbert")
    paddle.seed(0)
    jm = BertForPretraining(BertModel(**ranks.BERT))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    np.savez(tmp / "bert_state.npz", **state)
    np.savez(tmp / "batch.npz", **_batch())
    np.savez(tmp / "batch16.npz", **_batch(16))
    return {"dir": tmp, "state": state}


def _run_job(tmp, n, cases):
    tdist.spawn(ranks.job, args=(str(tmp), str(tmp / f"store{n}"), cases),
                nprocs=n, timeout=JOB_TIMEOUT_S)


@pytest.fixture(scope="module")
def job4(tmp_path_factory, bert_case):
    """One 4-rank job: the engine on every mesh and planted fault,
    ``sync_model``, and ``pipeline_apply``."""
    tmp = tmp_path_factory.mktemp("ppjob4")
    d = bert_case["dir"]
    files = tuple(str(d / f) for f in ("bert_state.npz", "batch.npz",
                                       "batch16.npz"))
    _run_job(tmp, 4, [("engine", files), ("sync", files[:2]),
                      ("pipeline_apply", ())])
    return str(tmp)


@pytest.fixture(scope="module")
def job2(tmp_path_factory, bert_case):
    """One 2-rank job: fleet at pp_degree 2."""
    tmp = tmp_path_factory.mktemp("ppjob2")
    d = bert_case["dir"]
    _run_job(tmp, 2, [("fleet", (str(d / "bert_state.npz"),
                                 str(d / "batch.npz")))])
    return str(tmp)


def _jax_engine_run(state, degrees, kw, batch):
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh as jbuild
    from paddle1_tpu.text.models import (BertForPretraining, BertModel,
                                         BertPretrainingCriterion)
    jm = BertForPretraining(BertModel(**ranks.BERT))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    crit = BertPretrainingCriterion(ranks.BERT["vocab_size"])

    def loss_fn(m, b):
        s, rel = m(Tensor(b["ids"]))
        return crit(s, rel, Tensor(b["mlm"]), Tensor(b["nsp"]))
    eng = JEngine(jm, paddle.optimizer.SGD(learning_rate=ranks.LR,
                                           parameters=jm.parameters()),
                  loss_fn, mesh=jbuild(devices=jax.devices()[:4], **degrees),
                  **kw)
    losses = [float(eng.step(batch)) for _ in range(ranks.STEPS)]
    eng.sync_model()
    return losses, {k: np.asarray(v) for k, v in eng.params.items()}


def _ws1_run(state_file, kw, batch):
    """The port's world-size-1 engine: the losses, the first step's
    gradient, the state before and after STEPS steps (tensors)."""
    tm = ranks.bert(state_file)
    init = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    ws1 = {k: v for k, v in kw.items()
           if k in ("grad_accum", "clip_global_norm", "recompute",
                    "check_finite")}
    eng = tdist.ParallelEngine(tm, ranks.sgd(tm.parameters()),
                               ranks.bert_loss(), **ws1)
    losses = [float(eng.step(batch))]
    grads = eng.full_grad_dict()
    losses += [float(eng.step(batch)) for _ in range(ranks.STEPS - 1)]
    state = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    return losses, grads, init, state


def _mesh(name):
    return [m for m in ranks.MESHES if m[0] == name][0]


def _global_batch(bert_case, kw):
    f = "batch16.npz" if kw.get("grad_accum", 1) > 1 else "batch.npz"
    return ranks.accum(dict(np.load(bert_case["dir"] / f)), kw)


def _part(got, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in got.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("mesh", [m[0] for m in ranks.MESHES])
def test_engine_on_4_ranks_matches_world_size_1(mesh, job4, bert_case):
    """Every mesh's three SGD steps (step_many under grad_accum, with the
    clip and recompute) equal world size 1's: the losses on every rank,
    the whole state gathered from the stages and shards, each rank
    holding only its stage's blocks."""
    _, degrees, kw = _mesh(mesh)
    out = _load(job4, "engine_" + mesh, 4)
    tl, _, _, tstate = _ws1_run(str(bert_case["dir"] / "bert_state.npz"),
                                kw, _global_batch(bert_case, kw))
    for got in out:
        np.testing.assert_allclose(got["losses"], tl, atol=WS1_TOL, rtol=0)
    state = _part(out[0], "state.")
    assert set(state) == set(tstate)
    for k, v in tstate.items():
        np.testing.assert_allclose(state[k], v, atol=WS1_TOL, rtol=0,
                                   err_msg=k)
    whole = sum(p.nelement() for p in ranks.bert(
        str(bert_case["dir"] / "bert_state.npz")).parameters())
    pp = degrees.get("pp", 1)
    for got in out:
        assert got["micro"].tolist() == ([kw.get("pp_microbatches", pp)]
                                         if pp > 1 else [])
        if pp > 1:
            assert int(got["param_numel"]) < whole


@pytest.mark.parametrize("mesh", ["pp4", "pp2_dp2"])
def test_engine_at_pp_matches_the_jax_engine(mesh, job4, bert_case):
    """pp 4 and pp 2 x dp 2 against the JAX engine's in-graph pipeline on
    the same meshes (its scan + ppermute schedule over pp)."""
    _, degrees, kw = _mesh(mesh)
    batch = _global_batch(bert_case, kw)
    out = _load(job4, "engine_" + mesh, 4)
    jl, jp = _jax_engine_run(bert_case["state"], degrees, kw, batch)
    for got in out:
        np.testing.assert_allclose(got["losses"], jl, atol=JAX_TOL, rtol=0)
    state = _part(out[0], "state.")
    for k, v in jp.items():
        np.testing.assert_allclose(state[k], v, atol=JAX_TOL, rtol=0,
                                   err_msg=k)


def _phase46_verdict(job4, bert_case, case, mesh):
    """``chip_smoke``'s phase-46 check (``hy_gaps``, ``pp_rep_gaps``,
    ``pp_verdict``) of the 4-rank run ``case`` against world size 1."""
    _, degrees, kw = _mesh(mesh)
    out = _load(job4, "engine_" + case, 4)
    tl, tg, t0, tp = _ws1_run(str(bert_case["dir"] / "bert_state.npz"), kw,
                              _global_batch(bert_case, kw))
    gaps = chip_smoke.hy_gaps(_part(out[0], "state."),
                              _part(out[0], "grad."), t0, tp, tg, ranks.LR)
    norms = [dict(zip(got["rep_keys"].tolist(),
                      got["rep_norms"].tolist())) for got in out]
    rep = chip_smoke.pp_rep_gaps(norms, t0, tp)
    res = [{"losses": got["losses"].tolist(), "gaps": gaps,
            "rep_gaps": rep} for got in out]
    return gaps, rep, chip_smoke.pp_verdict(case, res, tl)


@pytest.mark.parametrize("mesh", ["pp4", "pp2_dp2", "pp2_sh2_z2",
                                  "pp2_mp2_finite"])
def test_engine_at_pp_holds_phase_46s_check(mesh, job4, bert_case):
    """The first step's gradient gathered from every stage is world size
    1's, each parameter's gap a small share of its movement, and every
    rank's replicated tensors (embeddings, heads) rank 0's."""
    gaps, rep, verdict = _phase46_verdict(job4, bert_case, mesh, mesh)
    assert verdict == []
    assert max(gaps["grad_gap"].values()) <= 1e-5
    assert max(g for _, g in rep) <= 1e-5


@pytest.mark.parametrize("mesh,fault", ranks.PLANTED)
def test_phase_46s_check_fails_a_planted_fault(mesh, fault, job4,
                                               bert_case):
    """A zeroed cut gradient, a handoff a tick late or the input's
    gradient left unbroadcast each fail the check: the first two on the
    gradient, the last on the later stage's replicated embeddings."""
    gaps, rep, verdict = _phase46_verdict(
        job4, bert_case, f"{mesh}_planted_{fault}", mesh)
    assert verdict, fault
    if fault == "input_grad_bcast":
        assert any("replicated" in v for v in verdict), verdict
        assert max(g for _, g in rep) > 100 * chip_smoke.HY_MOVE_TOL
    else:
        assert any("first-step gradient" in v for v in verdict), verdict
        assert max(gaps["grad_gap"].values()) > 100 * chip_smoke.HY_GRAD_TOL


def test_sync_model_gathers_the_stages_and_the_next_step_drops_them(
        job4, bert_case):
    """At pp 4 a rank holds one block; ``sync_model`` puts every stage's
    blocks into the model, equal to ``full_state_dict``, and the whole
    model runs eagerly (the loss world size 1 reads before its third
    step); the next step holds one block again."""
    out = _load(job4, "sync", 4)
    tl, _, _, tstate = _ws1_run(str(bert_case["dir"] / "bert_state.npz"),
                                {}, _global_batch(bert_case, {}))
    whole = sum(v.nelement() for v in tstate.values())
    for got in out:
        assert bool(got["same_keys"]) and float(got["max_gap"]) == 0.0
        assert int(got["whole_numel"]) == whole
        assert int(got["held"]) == int(got["after_step"]) < whole
        np.testing.assert_allclose(float(got["eager_loss"]), tl[2],
                                   atol=WS1_TOL, rtol=0)


def test_pipeline_apply_on_4_ranks_equals_the_stages_in_turn(job4):
    """``pipeline_apply`` with every stage's stacked parameters and with
    this rank's stage alone (and ``micro_aux``): the last stage's outputs
    on every rank in micro-batch order, the input's gradient the same on
    every rank, each stage's parameter gradient its own, all equal to the
    four stages run in turn (1e-6)."""
    d = {k: torch.from_numpy(v) for k, v in ranks._pa_inputs().items()}
    out = _load(job4, "pipeline_apply", 4)
    for tag, aux in (("all", None), ("own", d["aux"])):
        w = d["w"].clone().requires_grad_()
        b = d["b"].clone().requires_grad_()
        x = d["x"].clone().requires_grad_()
        y = x
        for s in range(ranks.PA_STAGES):
            y = ranks.pa_stage({"w": w[s], "b": b[s]}, y, aux)
        (y * d["dy"]).sum().backward()
        for r, got in enumerate(out):
            np.testing.assert_allclose(got[f"{tag}_y"], y.detach(),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(got[f"{tag}_dx"], x.grad, atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(got[f"{tag}_dw"], w.grad[r],
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(got[f"{tag}_db"], b.grad[r],
                                       atol=1e-6, rtol=0)


def test_fleet_at_pp_degree_2_wraps_pipelines_and_compiles_the_micro_batches(
        job2, bert_case):
    """``distributed_model`` gives a ``PipelineParallel`` over a
    PipelineLayer of the hybrid group's two stages, and
    ``parallel_engine`` pipelines the tiny BERT in
    ``pipeline_configs.accumulate_steps`` micro-batches: the steps of
    world size 1."""
    out = _load(job2, "fleet", 2)
    tl, _, _, tstate = _ws1_run(str(bert_case["dir"] / "bert_state.npz"),
                                {}, _global_batch(bert_case, {}))
    for got in out:
        assert bool(got["is_pp"]) and str(got["wrapper"]) == \
            "PipelineParallel"
        assert int(got["stages"]) == 2 and got["parts"].tolist() == \
            [0, 2, 4]
        assert got["micro"].tolist() == [4] and int(got["pp"]) == 2
        np.testing.assert_allclose(got["losses"], tl, atol=WS1_TOL, rtol=0)
    state = _part(out[0], "state.")
    for k, v in tstate.items():
        np.testing.assert_allclose(state[k], v, atol=WS1_TOL, rtol=0,
                                   err_msg=k)
