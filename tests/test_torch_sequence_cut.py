"""Item 5(iv-b) of the PyTorch port against the JAX package, on the CPU:
``ParallelEngine`` with a ``batch_spec`` that cuts the sequence over
``sp`` (``data_partition_spec(("dp", "sharding"), seq_axis="sp")``, or
its tuple form), which GSPMD partitions for the JAX engine.

The multi-rank cases run in gloo ranks that the port's ``spawn`` starts
(``tests/test_torch_zero_seq_ranks.py`` holds their side), one job per
world size; the JAX engine runs the same meshes on the virtual 8-device
CPU mesh of ``tests/conftest.py``. The model is a tiny BERT (4 heads,
depth 2, sequence 16) on a batch with ragged padding, dropout off,
float32; three AdamW steps. Each tolerance is stated where it is used.
"""

import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle1_tpu as paddle
import test_torch_zero_seq_ranks as ranks
from paddle1_tpu.core.tensor import Tensor
from paddle1_tpu_torch import distributed as tdist

JOB_TIMEOUT_S = 300
# three AdamW steps of the tiny BERT: f32 sums in another order on each
# side, compounded (the BERT engine tests' tolerance)
TOL = 1e-4
# the attention key bias's gradient is rounding noise in both packages
# (tests/test_torch_train.py): Adam turns noise into steps of about lr
KEY_BIAS_TOL = ranks.STEPS * ranks.LR
# the meshes the JAX engine runs too (the recompute run with the tuple
# spec is held to world size 1)
JAX_MESHES = ("sp2", "sp4", "sp2_dp2", "sp2_sh2_z2", "sp2_sh2_z3", "sp2_mp2")
ALL_MESHES = [m[0] for m in ranks.SEQ_MESHES_2 + ranks.SEQ_MESHES_4]


def _batch(n=8, seq=16, vocab=128, seed=0):
    """Row i's last ``1 + i * seq // (3 n)`` ids are the pad id 0 (ragged
    padding the model masks), as ``chip_smoke.sq_batch`` pads."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (n, seq)).astype(np.int32)
    for i in range(n):
        ids[i, seq - 1 - (i * seq) // (3 * n):] = 0
    return {"ids": ids,
            "mlm": rng.integers(0, vocab, (n, seq)).astype(np.int32),
            "nsp": rng.integers(0, 2, (n,)).astype(np.int32)}


def _load(out, case, n):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in range(n)]


@pytest.fixture(scope="module")
def bert_case(tmp_path_factory):
    """The tiny BERT's JAX weights, the global batch and one whose
    sequence (15) does not divide over sp, saved for the ranks."""
    from paddle1_tpu.text.models import BertForPretraining, BertModel
    tmp = tmp_path_factory.mktemp("bert")
    paddle.seed(0)
    jm = BertForPretraining(BertModel(**ranks.BERT))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    np.savez(tmp / "state.npz", **state)
    np.savez(tmp / "batch.npz", **_batch())
    np.savez(tmp / "bad.npz", **_batch(seq=15))
    return {"dir": tmp, "state": state}


def _run_job(tmp, n, cases):
    tdist.spawn(ranks.job, args=(str(tmp), str(tmp / f"store{n}"), cases),
                nprocs=n, timeout=JOB_TIMEOUT_S)
    return str(tmp)


def _files(bert_case):
    d = bert_case["dir"]
    return str(d / "state.npz"), str(d / "batch.npz"), str(d / "bad.npz")


@pytest.fixture(scope="module")
def job2(tmp_path_factory, bert_case):
    """sp 2, the refusals and fleet at sep_degree 2 on two ranks."""
    s, b, bad = _files(bert_case)
    return _run_job(tmp_path_factory.mktemp("job2"), 2, [
        ("seq", (s, b, ranks.SEQ_MESHES_2)),
        ("seq_refusals", (s, b, bad)), ("fleet_sep", (s, b))])


@pytest.fixture(scope="module")
def job4(tmp_path_factory, bert_case):
    """The four-rank meshes, the planted faults and the refusals."""
    s, b, bad = _files(bert_case)
    return _run_job(tmp_path_factory.mktemp("job4"), 4, [
        ("seq", (s, b, ranks.SEQ_MESHES_4, ranks.SEQ_PLANTED)),
        ("seq_refusals", (s, b, bad))])


def _ranks_of(mesh):
    return 2 if mesh in [m[0] for m in ranks.SEQ_MESHES_2] else 4


def _out(mesh, job2, job4):
    n = _ranks_of(mesh)
    return _load(job2 if n == 2 else job4, mesh, n)


def _jax_engine(state, degrees, kw):
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh as jbuild
    from paddle1_tpu.distributed.sharding_specs import data_partition_spec
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
    return JEngine(jm, paddle.optimizer.AdamW(learning_rate=ranks.LR,
                                              parameters=jm.parameters()),
                   loss_fn, mesh=jbuild(devices=jax.devices()[:n], **degrees),
                   batch_spec=data_partition_spec(("dp", "sharding"),
                                                  seq_axis="sp"), **kw)


def _jax_run(state, degrees, kw, batch):
    eng = _jax_engine(state, degrees, kw)
    losses = [float(eng.step(batch)) for _ in range(ranks.STEPS)]
    eng.sync_model()
    return losses, {k: np.asarray(v) for k, v in eng.params.items()}


@pytest.fixture(scope="module")
def ws1(bert_case):
    """The port at world size 1 on the whole batch: the losses, the first
    step's gradient, the state before and after the steps."""
    tm = ranks.bert(str(bert_case["dir"] / "state.npz"))
    init = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    eng = tdist.ParallelEngine(tm, _adamw(tm), ranks.bert_loss())
    batch = dict(np.load(bert_case["dir"] / "batch.npz"))
    losses = [float(eng.step(batch))]
    grads = eng.full_grad_dict()
    losses += [float(eng.step(batch)) for _ in range(ranks.STEPS - 1)]
    state = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    return {"losses": losses, "grads": grads, "init": init,
            "state": state}


def _adamw(tm):
    from paddle1_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=ranks.LR, parameters=tm.parameters())


def _close(got, want, what):
    for k, v in want.items():
        if k not in got:
            continue          # the tied alias: the JAX engine keeps one
        tol = KEY_BIAS_TOL if k.endswith("k_proj.bias") else TOL
        np.testing.assert_allclose(got[k], np.asarray(v), atol=tol, rtol=0,
                                   err_msg=f"{what}: {k}")


def _part(got, prefix):
    return {k[len(prefix):]: v for k, v in got.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_sequence_cut_matches_the_jax_engine_and_world_size_1(
        mesh, job2, job4, bert_case, ws1):
    """Every rank's losses and rank 0's whole state after three steps,
    the sequence cut over sp, within 1e-4 of world size 1 on the whole
    batch and (but for the recompute run) of the JAX engine on the same
    mesh and spec: sp 2 and 4, composed with dp, with ZeRO 2 and 3 at
    sharding 2 and with mp 2, and under recompute with the tuple spec."""
    out = _out(mesh, job2, job4)
    state = _part(out[0], "state.")
    for got in out:
        np.testing.assert_allclose(got["losses"], ws1["losses"], atol=TOL,
                                   rtol=0)
    _close(state, {k: v.numpy() for k, v in ws1["state"].items()},
           "against world size 1")
    assert set(state) == set(ws1["state"])
    assert np.all(np.diff(ws1["losses"]) < 0)
    if mesh in JAX_MESHES:
        _, degrees, kw = [m for m in ranks.SEQ_MESHES_2 + ranks.SEQ_MESHES_4
                          if m[0] == mesh][0]
        jl, jp = _jax_run(bert_case["state"], degrees, kw,
                          dict(np.load(bert_case["dir"] / "batch.npz")))
        for got in out:
            np.testing.assert_allclose(got["losses"], jl, atol=TOL, rtol=0)
        _close(state, jp, "against the JAX engine")


def _phase49_verdict(case, mesh, job2, job4, ws1):
    """``chip_smoke``'s phase-49 check (``hy_gaps``, ``pp_verdict``) of the
    run ``case`` against world size 1."""
    n = _ranks_of(mesh)
    out = _load(job2 if n == 2 else job4, case, n)
    gaps = chip_smoke.hy_gaps(
        {k: torch.from_numpy(v) for k, v in _part(out[0], "state.").items()},
        {k: torch.from_numpy(v) for k, v in _part(out[0], "grad.").items()},
        ws1["init"], ws1["state"], ws1["grads"], ranks.LR)
    every = [dict(zip(got["rep_norm_keys"].tolist(),
                      got["rep_norms"].tolist())) for got in out]
    res = [{"losses": got["losses"].tolist(), "gaps": gaps,
            "rep_gaps": chip_smoke.pp_rep_gaps(every, ws1["init"],
                                               ws1["state"])}
           for got in out]
    return gaps, chip_smoke.pp_verdict(case, res, ws1["losses"])


@pytest.mark.parametrize("mesh", ["sp2", "sp2_dp2", "sp2_sh2_z3"])
def test_sequence_cut_holds_phase_49s_check(mesh, job2, job4, ws1):
    """The first step's gradient (every shard gathered), each parameter's
    gap over its movement, the losses of every rank and every rank's
    replicated tensors (embeddings, pooler, heads) against rank 0's: the
    chip's phase-49 check holds on the CPU."""
    gaps, verdict = _phase49_verdict(mesh, mesh, job2, job4, ws1)
    assert verdict == []
    assert max(gaps["grad_gap"].values()) <= 1e-5


@pytest.mark.parametrize("mesh,fault", ranks.SEQ_PLANTED)
def test_phase_49s_check_fails_a_planted_fault(mesh, fault, job2, job4,
                                               ws1):
    """The blocks' gradients left unsummed over sp, the input's gradient
    left ungathered, the key mask cut with the sequence, or one ZeRO
    unit's reduce-scatter written off its offset each fail the check on
    the first step's gradient."""
    gaps, verdict = _phase49_verdict(f"{mesh}_planted_{fault}", mesh, job2,
                                     job4, ws1)
    assert any("first-step gradient" in v for v in verdict), verdict
    assert max(gaps["grad_gap"].values()) > 100 * chip_smoke.HY_GRAD_TOL


def test_a_sequence_that_does_not_divide_raises_in_both_packages(
        job2, job4, bert_case):
    """A leaf of two or more axes whose second (15) does not divide over
    sp: the port's ``shard_batch`` raises ``InvalidArgumentError`` where
    the JAX engine's ``jax.device_put`` raises."""
    for out, n in ((job2, 2), (job4, 4)):
        said = str(_load(out, f"refusals{n}", n)[0]["indivisible"])
        assert said.startswith("InvalidArgumentError") and \
            f"sp={n}" in said, said
    eng = _jax_engine(bert_case["state"], {"sp": 2}, {})
    with pytest.raises(ValueError):
        eng.shard_batch(dict(np.load(bert_case["dir"] / "bad.npz")))


def test_pp_with_a_sequence_cut_raises_naming_item_5_iv_c(job4):
    said = str(_load(job4, "refusals4", 4)[0]["pp_sp"])
    assert said.startswith("UnimplementedError") and "5(iv-c)" in said, \
        said


def test_ulysses_heads_that_do_not_divide_raise(job2):
    """Three heads over two sp ranks: the masked helper raises as
    ``ulysses_attention`` does."""
    said = str(_load(job2, "refusals2", 2)[0]["heads"])
    assert said.startswith("InvalidArgumentError") and \
        "not divisible by sp=2" in said, said


def test_fleet_sep_degree_passes_the_sequence_spec(job2, ws1):
    """``hybrid_configs["sep_degree"]`` is the sp degree, and
    ``fleet.parallel_engine(..., batch_spec=...)`` cuts the sequence: the
    steps are world size 1's."""
    for got in _load(job2, "fleet_sep", 2):
        assert int(got["sp"]) == 2 and int(got["dp"]) == 1 and \
            bool(got["cut"])
        np.testing.assert_allclose(got["losses"], ws1["losses"], atol=TOL,
                                   rtol=0)
