"""Slice 4b(i)-(ii) of the PyTorch port against the JAX package and
against dense math, on the CPU: the rest of the collectives, the hybrid
topology, the tensor-parallel layers, ``fleet``, and ``ParallelEngine``
at hybrid meshes with ZeRO 1-3 and tensor parallelism.

The multi-rank cases run in gloo ranks that the port's ``spawn`` starts
(``tests/test_torch_hybrid_ranks.py`` holds their side), one job per
world size: each rank joins through a ``FileStore`` under the test's
temporary directory, runs single-threaded, and the job has a hard
timeout. The JAX engine runs the same meshes on the virtual 8-device CPU
mesh of ``tests/conftest.py`` (``devices=`` its first four), where GSPMD
places the collectives the port places itself. Everything is float32;
each tolerance is stated where it is used.

The JAX package's Megatron pairs are red (``tests/test_collective.py::
TestMegatronPairsTrace``), so the port's are held to hand-derived
forwards and gradients, and the mp layers to dense layers with the same
weights; the JAX engine (green) is the oracle for whole steps.
"""

import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle1_tpu as paddle
import test_torch_hybrid_ranks as ranks
from paddle1_tpu.core.tensor import Tensor
from paddle1_tpu_torch import distributed as tdist
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.optimizer import AdamW

JOB_TIMEOUT_S = 300
# three AdamW steps of the tiny BERT: f32 sums in another order on each
# side, compounded (the BERT engine tests' tolerance)
ENGINE_TOL = 1e-4
# the attention key bias's gradient is rounding noise in both packages
# (tests/test_torch_train.py): Adam turns noise into steps of about lr
KEY_BIAS_TOL = ranks.STEPS * ranks.LR
# one small layer's sums in f32
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def _load(out, case, n):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in range(n)]


def _batch(n=8, seq=16, vocab=64):
    rng = np.random.default_rng(0)     # tests/test_parallel_engine.py's
    return {"ids": rng.integers(1, vocab, (n, seq)).astype(np.int32),
            "mlm": rng.integers(0, vocab, (n, seq)).astype(np.int32),
            "nsp": rng.integers(0, 2, (n,)).astype(np.int32)}


@pytest.fixture(scope="module")
def bert_case(tmp_path_factory):
    """The tiny BERT's JAX weights and the global batches (8 rows; 16 as
    [2, 8] under grad_accum), saved for the ranks."""
    from paddle1_tpu.text.models import BertForPretraining, BertModel
    tmp = tmp_path_factory.mktemp("bert")
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
def job2(tmp_path_factory, bert_case):
    """One 2-rank job: the collectives, the mp layers and fleet."""
    tmp = tmp_path_factory.mktemp("job2")
    for f in ("bert_state.npz", "batch.npz"):
        (tmp / f).write_bytes((bert_case["dir"] / f).read_bytes())
    _run_job(tmp, 2, [("collectives", ()), ("mp_layers", ()),
                      ("fleet", ())])
    return str(tmp)


@pytest.fixture(scope="module")
def job4(tmp_path_factory, bert_case):
    """One 4-rank job: the collectives, the topology and the five engine
    meshes."""
    tmp = tmp_path_factory.mktemp("job4")
    d = bert_case["dir"]
    _run_job(tmp, 4, [("collectives", ()), ("topology", ()),
                      ("engine", (str(d / "bert_state.npz"),
                                  str(d / "batch.npz"),
                                  str(d / "batch16.npz")))])
    return str(tmp)


# ---------------------------------------------------------------------------
# (a) the collectives, against numpy


@pytest.mark.parametrize("n", [2, 4])
def test_new_collectives_over_gloo_ranks(n, job2, job4):
    out = _load(job2 if n == 2 else job4, f"collectives{n}", n)
    base = [np.arange(6, dtype=np.float32) + 10.0 * r for r in range(n)]
    full = [np.arange(2 * n, dtype=np.float32) + 100.0 * r for r in range(n)]
    total = np.sum(full, axis=0)
    for r, got in enumerate(out):
        assert got["objects"].tolist() == list(range(n))
        assert got["object_tags"].tolist() == [f"r{j}" for j in range(n)]
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      total[2 * r:2 * r + 2])
        np.testing.assert_allclose(got["reduce_scatter_avg"],
                                   total[2 * r:2 * r + 2] / n, rtol=1e-7)
        np.testing.assert_array_equal(got["reduce_scatter_max"],
                                      full[-1][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["scatter"], base[r] + 1000.0)
        np.testing.assert_array_equal(
            got["alltoall"], np.stack([base[j] + r for j in range(n)]))
        np.testing.assert_array_equal(
            got["alltoall_tensor"], np.stack([base[j] * (r + 1)
                                              for j in range(n)]))
        np.testing.assert_array_equal(got["recv"], base[(r - 1) % n])
        np.testing.assert_array_equal(got["irecv"], 2 * base[(r - 1) % n])
        np.testing.assert_array_equal(got["all_gather_into"],
                                      np.repeat(np.arange(n), 2))
        two = np.stack([np.sum(base, 0), np.sum(base, 0) + n])
        np.testing.assert_array_equal(got["hier"], two)
        np.testing.assert_array_equal(got["hier_odd"], np.sum(base, 0)[:5])


@pytest.mark.parametrize("n", [2, 4])
def test_megatron_pairs_forward_and_hand_derived_gradients(n, job2, job4):
    """Rank r's cotangent is ``(r + 1)`` times a fixed pattern: f's
    gradient is their sum, g's the rank's own, c_concat's the rank's
    slice, c_split's every rank's slice gathered."""
    out = _load(job2 if n == 2 else job4, f"collectives{n}", n)
    base = [np.arange(6, dtype=np.float32) + 10.0 * r for r in range(n)]
    csum = n * (n + 1) / 2
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["ident_y"], base[r])
        np.testing.assert_array_equal(got["ident_g"], np.full(6, csum))
        np.testing.assert_array_equal(got["allred_y"], np.sum(base, 0))
        np.testing.assert_array_equal(got["allred_g"], np.full(6, r + 1.0))
        cat = np.concatenate([b.reshape(2, 3) for b in base], -1)
        np.testing.assert_array_equal(got["concat_y"], cat)
        pattern = np.arange(cat.size, dtype=np.float32).reshape(cat.shape)
        np.testing.assert_array_equal(got["concat_g"],
                                      (pattern * (r + 1))[:, 3 * r:3 * r + 3])
        x = np.arange(4.0 * n).reshape(2, 2 * n)
        np.testing.assert_array_equal(got["split_y"], x[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["split_fn"], x[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            got["split_g"], np.repeat(np.arange(1.0, n + 1), 2)[None]
            .repeat(2, 0))


def test_collectives_and_pairs_are_the_identity_without_a_group():
    t = torch.arange(6.0)
    objs = []
    tdist.all_gather_object(objs, "x")
    assert objs == ["x"]
    assert torch.equal(tdist.reduce_scatter(torch.zeros(6), t), t)
    assert torch.equal(tdist.scatter(torch.zeros(6), [t]), t)
    assert torch.equal(tdist.alltoall([t]), t[None])
    from paddle1_tpu_torch.distributed import collective as C
    for fn in (C._c_identity, C._mp_allreduce, C._c_concat, C._c_split):
        assert fn(t) is t
    assert torch.equal(tdist.split(t.reshape(2, 3), 1, axis=-1),
                       t.reshape(2, 3))
    with pytest.raises(Exception, match="init_parallel_env|peer"):
        tdist.send(t, dst=1)


# ---------------------------------------------------------------------------
# (b) the topology, against the JAX package


def test_mesh_coordinates_and_groups_are_the_jax_meshs(job4):
    """Rank r takes device r's place in the JAX mesh's reshape, and each
    group holds the ranks the JAX mesh's axis slice holds."""
    from paddle1_tpu.distributed import build_mesh as jbuild
    out = _load(job4, "topology", 4)
    devs = jax.devices()[:4]
    ids = {d.id: i for i, d in enumerate(devs)}
    for tag, kw in (("dp2_mp2", dict(dp=2, mp=2)),
                    ("sh2_mp2", dict(sharding=2, mp=2)),
                    ("pp2_dp2", dict(pp=2, dp=2)),
                    ("dp2_sh2", dict(dp=2, sharding=2)),
                    ("sp2_sh2", dict(sp=2, sharding=2))):
        jm = jbuild(devices=devs, **kw)
        arr = np.vectorize(lambda d: ids[d.id])(jm.devices)
        for r, got in enumerate(out):
            where = tuple(int(i[0]) for i in np.nonzero(arr == r))
            assert got[f"{tag}_coords"].tolist() == list(where), tag
            for i, axis in enumerate(jm.axis_names):
                sl = list(where)
                sl[i] = slice(None)
                assert got[f"{tag}_{axis}"].tolist() == \
                    arr[tuple(sl)].tolist(), (tag, axis)
            data = list(where)
            data[1] = data[2] = slice(None)
            assert sorted(got[f"{tag}_data"].tolist()) == \
                sorted(arr[tuple(data)].ravel().tolist())
    for got in out:
        # pp needs a pipelined body (TransformerEncoder), as the JAX
        # engine says; sp replicates the batch and takes any model
        raises = got["engine_raises"].tolist()
        assert "pipelined body" in raises[0] and raises[1] == ""


def test_communicate_topology_and_hcg_equal_the_jax_packages():
    from paddle1_tpu.distributed import topology as jt
    from paddle1_tpu_torch.distributed import topology as tt
    names = ["pp", "dp", "sharding", "mp", "sp"]
    dims = [2, 2, 1, 2, 1]
    j, t = jt.CommunicateTopology(names, dims), \
        tt.CommunicateTopology(names, dims)
    assert t.world_size() == j.world_size() == 8
    for r in range(8):
        assert t.get_coord(r) == tuple(int(c) for c in j.get_coord(r))
    for a in names:
        assert t.get_comm_list(a) == j.get_comm_list(a)
        assert t.get_axis_list(a, 0) == j.get_axis_list(a, 0)
        assert t.get_dim(a) == j.get_dim(a)
    assert t.get_rank(pp=1, dp=0, sharding=0, mp=1, sp=0) == \
        j.get_rank(pp=1, dp=0, sharding=0, mp=1, sp=0)
    one = tt.CommunicateTopology(names, [1] * 5)
    hcg = tt.HybridCommunicateGroup(one)
    jhcg = jt.HybridCommunicateGroup(
        jt.CommunicateTopology(names, [1] * 5),
        mesh=jt.build_mesh(devices=jax.devices()[:1]))
    for q in ("get_data_parallel_world_size", "get_model_parallel_rank",
              "get_model_parallel_world_size", "get_stage_id",
              "get_sharding_parallel_world_size", "is_first_stage",
              "is_last_stage", "get_sep_parallel_world_size"):
        assert getattr(hcg, q)() == getattr(jhcg, q)(), q
    assert hcg.get_model_parallel_group().nranks == 1
    assert hcg.axis_name("model") == jhcg.axis_name("model") == "mp"


def test_plan_resize_and_ensure_reshardable_equal_the_jax_packages():
    from paddle1_tpu.distributed import topology as jt
    from paddle1_tpu_torch.distributed import topology as tt
    cases = [({"dp": 2, "sharding": 2, "mp": 2}, 16),
             ({"dp": 1, "sharding": 4}, 8), ({"dp": 4}, 2),
             ({"dp": 2, "sharding": 2, "mp": 2}, 12),
             ({"mp": 4}, 6)]
    for axes, n in cases:
        old_j = jt.MeshDescriptor(axes=axes, device_count=8)
        old_t = tt.MeshDescriptor(axes=axes, device_count=8)
        assert old_t.digest() == old_j.digest()
        assert old_t.as_meta() == old_j.as_meta()
        try:
            want = jt.plan_resize(old_j, n)
        except jt.ReshardError:
            with pytest.raises(tt.ReshardError):
                tt.plan_resize(old_t, n)
            continue
        assert tt.plan_resize(old_t, n) == want
    saved = tt.MeshDescriptor({"dp": 2, "mp": 2}, 4)
    assert tt.ensure_reshardable(saved, tt.MeshDescriptor({"dp": 2,
                                                           "mp": 2}, 4)) \
        is False
    assert tt.ensure_reshardable(saved, tt.MeshDescriptor({"dp": 4,
                                                           "mp": 2}, 8))
    with pytest.raises(tt.ReshardError, match="mp=2"):
        tt.ensure_reshardable(saved, tt.MeshDescriptor({"dp": 4}, 4))
    assert tt.MeshDescriptor.from_meta(saved.as_meta()) == saved
    mesh = tdist.build_mesh(dp=1)
    assert tt.mesh_descriptor(mesh).as_meta() == jt.mesh_descriptor(
        jt.build_mesh(devices=jax.devices()[:1])).as_meta()


def test_sharding_specs_of_a_tagged_tiny_bert_equal_the_jax_packages(
        bert_case):
    from paddle1_tpu.distributed import sharding_specs as js
    from paddle1_tpu.text.models import BertForPretraining as JBert
    from paddle1_tpu.text.models import BertModel as JBertModel
    from paddle1_tpu.text.models import apply_megatron_sharding as jtag
    from paddle1_tpu_torch.distributed import sharding_specs as ts
    paddle.seed(0)
    jm = jtag(JBert(JBertModel(**ranks.BERT)))
    tm = ranks.bert(str(bert_case["dir"] / "bert_state.npz"))
    for stage, size in ((0, 1), (2, 4), (3, 4), (3, 3)):
        want = js.param_partition_specs(jm, zero_stage=stage,
                                        zero_axis_size=size)
        got = ts.param_partition_specs(tm, zero_stage=stage,
                                       zero_axis_size=size)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == tuple(want[k]), (stage, size, k)
            shape = tuple(tm.state_dict()[k].shape)
            assert ts.zero_shard_spec(got[k], shape, zero_axis_size=size) \
                == tuple(js.zero_shard_spec(want[k], shape,
                                            zero_axis_size=size)), k
    assert ts.data_partition_spec() == tuple(js.data_partition_spec())
    assert ts.data_partition_spec(("dp",), "sp") == \
        tuple(js.data_partition_spec(("dp",), "sp"))
    layout = ts.describe_layout({"w": tm.bert.embeddings.word_embeddings
                                 .weight, "b": torch.zeros(2)})
    assert layout == {"['w']": "('mp', None)"}


# ---------------------------------------------------------------------------
# (c) the mp layers on 2 ranks against dense layers with the same weights


def test_mp_layers_on_2_ranks_equal_dense_layers(job2):
    d = ranks.mp_inputs()
    out = _load(job2, "mp_layers", 2)
    w, b, x, dy = (torch.from_numpy(d[k]) for k in ("w", "b", "x", "dy"))
    xg = x.clone().requires_grad_()
    wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
    y = xg @ wg + bg
    (y * dy).sum().backward()
    k = ranks.MP_OUT // 2
    for r, got in enumerate(out):
        cols = slice(r * k, (r + 1) * k)
        np.testing.assert_allclose(got["col_1_y"], y.detach(), **LAYER_TOL)
        np.testing.assert_allclose(got["col_0_y"], y.detach()[:, cols],
                                   **LAYER_TOL)
        for g in ("col_1", "col_0"):
            np.testing.assert_allclose(got[g + "_dx"], xg.grad, **LAYER_TOL)
            np.testing.assert_allclose(got[g + "_dw"], wg.grad[:, cols],
                                       **LAYER_TOL)
            np.testing.assert_allclose(got[g + "_db"], bg.grad[cols],
                                       **LAYER_TOL)
        rows = slice(r * ranks.MP_IN // 2, (r + 1) * ranks.MP_IN // 2)
        np.testing.assert_allclose(got["row_0_y"], y.detach(), **LAYER_TOL)
        np.testing.assert_allclose(got["row_0_dx"], xg.grad, **LAYER_TOL)
        np.testing.assert_allclose(got["row_0_dw"], wg.grad[rows],
                                   **LAYER_TOL)
        np.testing.assert_allclose(got["row_0_db"], bg.grad, **LAYER_TOL)
        # input_is_parallel: the first 4 inputs, 2 a rank
        x4 = x[:, :4].clone().requires_grad_()
        w4 = w[:4].clone().requires_grad_()
        y4 = x4 @ w4 + b
        (y4 * dy).sum().backward()
        np.testing.assert_allclose(got["row_1_y"], y4.detach(), **LAYER_TOL)
        np.testing.assert_allclose(got["row_1_dx"],
                                   x4.grad[:, 2 * r:2 * r + 2], **LAYER_TOL)
        np.testing.assert_allclose(got["row_1_dw"],
                                   w4.grad[2 * r:2 * r + 2], **LAYER_TOL)
    emb = torch.from_numpy(d["emb"]).requires_grad_()
    ey = torch.nn.functional.embedding(torch.from_numpy(d["ids"]), emb)
    (ey * dy[:, None, :]).sum().backward()
    lg = torch.from_numpy(d["logits"]).requires_grad_()
    lab = torch.from_numpy(d["label"])
    ce = torch.nn.functional.cross_entropy(lg, lab, reduction="none")
    (ce * torch.arange(1.0, ranks.MP_ROWS + 1)).sum().backward()
    v = ranks.MP_VOCAB // 2
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["emb_y"], ey.detach(), **LAYER_TOL)
        np.testing.assert_allclose(got["emb_dw"], emb.grad[r * v:(r + 1) * v],
                                   **LAYER_TOL)
        np.testing.assert_allclose(got["ce_loss"][:, 0], ce.detach(),
                                   **LAYER_TOL)
        np.testing.assert_allclose(got["ce_dlogits"],
                                   lg.grad[:, r * v:(r + 1) * v],
                                   **LAYER_TOL)


# ---------------------------------------------------------------------------
# (d) the engine at five meshes on 4 ranks, against the JAX engine on the
# same meshes and the port's world-size-1 engine


def _jax_engine_run(state, degrees, kw, batch):
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh as jbuild
    from paddle1_tpu.text.models import (BertForPretraining, BertModel,
                                         BertPretrainingCriterion,
                                         apply_megatron_sharding)
    jm = BertForPretraining(BertModel(**ranks.BERT))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    apply_megatron_sharding(jm)
    crit = BertPretrainingCriterion(64)

    def loss_fn(m, b):
        s, rel = m(Tensor(b["ids"]))
        return crit(s, rel, Tensor(b["mlm"]), Tensor(b["nsp"]))
    eng = JEngine(jm, paddle.optimizer.AdamW(learning_rate=ranks.LR,
                                             parameters=jm.parameters()),
                  loss_fn, mesh=jbuild(devices=jax.devices()[:4], **degrees),
                  **kw)
    losses = [float(eng.step(batch)) for _ in range(ranks.STEPS)]
    eng.sync_model()
    return losses, {k: np.asarray(v) for k, v in eng.params.items()}


def _port_ws1_run(state_file, kw, batch, first_grads=False):
    """The port's world-size-1 engine: the losses and the state after
    STEPS steps (``first_grads``: also the first step's gradient and the
    state before the steps, as tensors)."""
    tm = ranks.bert(state_file)
    init = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    eng = tdist.ParallelEngine(tm, AdamW(learning_rate=ranks.LR,
                                         parameters=tm.parameters()),
                               ranks.bert_loss(), **kw)
    losses = [float(eng.step(batch))]
    grads = eng.full_grad_dict()
    losses += [float(eng.step(batch)) for _ in range(ranks.STEPS - 1)]
    if first_grads:
        return losses, {k: v.detach().clone()
                        for k, v in tm.state_dict().items()}, grads, init
    return losses, {k: v.detach().numpy()
                    for k, v in tm.state_dict().items()}


def _accum(batch, kw):
    n = kw.get("grad_accum", 1)
    if n == 1:
        return batch
    return {k: v.reshape((n, -1) + v.shape[1:]) for k, v in batch.items()}


def _close(got, want, what):
    for k, v in want.items():
        if k not in got:
            continue          # the tied alias: the JAX engine keeps one
        tol = KEY_BIAS_TOL if k.endswith("k_proj.bias") else ENGINE_TOL
        np.testing.assert_allclose(got[k], v, atol=tol, rtol=0,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("mesh", [m[0] for m in ranks.MESHES])
def test_engine_on_4_ranks_matches_the_jax_engine_and_world_size_1(
        mesh, job4, bert_case):
    _, degrees, kw = [m for m in ranks.MESHES if m[0] == mesh][0]
    bfile = "batch16.npz" if kw.get("grad_accum", 1) > 1 else "batch.npz"
    batch = _accum(dict(np.load(bert_case["dir"] / bfile)), kw)
    out = _load(job4, "engine_" + mesh, 4)
    state = {k[len("state."):]: v for k, v in out[0].items()
             if k.startswith("state.")}
    jl, jp = _jax_engine_run(bert_case["state"], degrees, kw, batch)
    tl, tp = _port_ws1_run(str(bert_case["dir"] / "bert_state.npz"), kw,
                           batch)
    for got in out:
        np.testing.assert_allclose(got["losses"], jl, atol=ENGINE_TOL,
                                   rtol=0)
        np.testing.assert_allclose(got["losses"], tl, atol=ENGINE_TOL,
                                   rtol=0)
    assert np.all(np.diff(jl) < 0)
    _close(state, jp, "against the JAX engine")
    _close(state, tp, "against the port at world size 1")
    assert set(state) == set(tp)
    shards = degrees.get("sharding", 1)
    if kw.get("zero_stage", 0) >= 1:
        # the slots (Adam's two f32 moments an element) are cut among the
        # ranks: together the whole, each rank about 1/n of it (the flat
        # buffer pads every tensor to 64 elements and its end to n x 64)
        whole = 2 * 4 * out[0]["param_numel"]
        groups = 4 // shards      # sharding groups (the dp and mp ranks)
        assert sum(int(got["slot_bytes"]) for got in out) == whole * groups
        for got in out:
            assert int(got["slot_bytes"]) <= whole / shards + \
                2 * 4 * 64 * (len(tp) + shards)
        # a step: one reduce-scatter of the gradients a unit (the root
        # unit and each block), the parameters all-gathered a unit at a
        # time (stages 1-2: after the update; stage 3: the root unit for
        # the step, a block before its forward and again before its
        # backward), and under mp the tied decoder's logits gathered
        blocks = ranks.BERT["num_hidden_layers"]
        assert int(out[0]["calls_reduce_scatter"]) == 1 + blocks
        gathers = 1 + 2 * blocks if kw["zero_stage"] >= 3 else 1 + blocks
        assert int(out[0]["calls_all_gather"]) == \
            gathers + (degrees.get("mp", 1) > 1)


def _phase45_verdict(job4, bert_case, case, mesh):
    """``chip_smoke``'s phase-45 check (``hy_gaps``, ``hy_verdict``) of the
    4-rank run ``case`` against the port's world size 1."""
    _, degrees, kw = [m for m in ranks.MESHES if m[0] == mesh][0]
    bfile = "batch16.npz" if kw.get("grad_accum", 1) > 1 else "batch.npz"
    batch = _accum(dict(np.load(bert_case["dir"] / bfile)), kw)
    out = _load(job4, "engine_" + case, 4)

    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(v)
                for k, v in out[0].items() if k.startswith(prefix)}
    tl, tp, tg, t0 = _port_ws1_run(str(bert_case["dir"] /
                                       "bert_state.npz"), kw, batch,
                                   first_grads=True)
    gaps = chip_smoke.hy_gaps(part("state."), part("grad."), t0, tp, tg,
                              ranks.LR)
    assert set(part("grad.")) == set(tg)
    res = [{"losses": got["losses"].tolist(), "gaps": gaps} for got in out]
    return gaps, chip_smoke.hy_verdict(case, res, tl)


@pytest.mark.parametrize("mesh", [m[0] for m in ranks.MESHES])
def test_engine_on_4_ranks_holds_phase_45s_gradient_and_movement_check(
        mesh, job4, bert_case):
    """The first step's gradient, every ZeRO and mp shard gathered by
    ``full_grad_dict``, is world size 1's, and each parameter's gap after
    the steps is a small share of its movement: the chip's phase-45 check
    holds on the CPU at every mesh, the attention key biases (no gradient
    but rounding) held apart."""
    gaps, verdict = _phase45_verdict(job4, bert_case, mesh, mesh)
    assert verdict == []
    assert sorted(gaps["flat_gap_in_lr"]) == [
        f"bert.encoder.layers.{i}.self_attn.k_proj.bias" for i in range(2)]
    assert max(gaps["grad_gap"].values()) <= 1e-5


@pytest.mark.parametrize("mesh,fault", ranks.PLANTED)
def test_phase_45s_check_fails_a_planted_fault(mesh, fault, job4,
                                               bert_case):
    """A gradient shard zeroed, a reduce-scatter left unaveraged (which
    Adam's update hardly sees) or Megatron's f dropped from one
    projection each fail the check, on the first step's gradient."""
    gaps, verdict = _phase45_verdict(job4, bert_case,
                                     f"{mesh}_planted_{fault}", mesh)
    assert any("first-step gradient" in v for v in verdict), verdict
    assert max(gaps["grad_gap"].values()) > 100 * chip_smoke.HY_GRAD_TOL


# ---------------------------------------------------------------------------
# (g) fleet on 2 ranks against the whole batch


def test_fleet_distributed_model_and_optimizer_equal_the_whole_batch(
        job2, bert_case):
    from paddle1_tpu_torch.nn import Linear, ReLU, Sequential
    from paddle1_tpu_torch.optimizer import SGD
    from paddle1_tpu_torch.utils import unique_name
    out = _load(job2, "fleet", 2)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    with unique_name.guard():
        gen = torch.Generator().manual_seed(31)
        net = Sequential(Linear(6, 8, device="cpu", generator=gen), ReLU(),
                         Linear(8, 3, device="cpu", generator=gen))
    opt = SGD(learning_rate=0.1, parameters=net.parameters())
    ((net(x) - t) ** 2).mean().backward()
    opt.step()
    tm = ranks.bert(str(bert_case["dir"] / "bert_state.npz"))
    topt = AdamW(learning_rate=ranks.LR, parameters=tm.parameters())
    b = {k: torch.from_numpy(v) for k, v in
         np.load(bert_case["dir"] / "batch.npz").items()}
    loss = ranks.bert_loss()(tm, b)
    loss.backward()
    topt.step()
    for r, got in enumerate(out):
        assert int(got["dp_worker_num"]) == 2 and \
            int(got["dp_worker_index"]) == r and int(got["hcg_dp"]) == 2
        for k, v in net.state_dict().items():
            np.testing.assert_allclose(got["dp." + k], v.detach(),
                                       **LAYER_TOL)
        assert int(got["hcg_mp"]) == 2 and int(got["hcg_mp_rank"]) == r
        np.testing.assert_allclose(got["mp_loss"], float(loss),
                                   atol=1e-5, rtol=0)
        for k, v in tm.state_dict().items():
            tol = KEY_BIAS_TOL if k.endswith("k_proj.bias") else 1e-5
            np.testing.assert_allclose(got["mp." + k], v.detach(),
                                       atol=tol, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# (e) the tracker's semantics across model-parallel ranks


def test_model_parallel_rng_streams_differ_by_rank_and_default_agrees(job2):
    out = _load(job2, "fleet", 2)
    for key in ("rng_default", "rng_default_after"):
        np.testing.assert_array_equal(out[0][key], out[1][key])
    assert not np.array_equal(out[0]["rng_tracked"], out[1]["rng_tracked"])
    # the default stream goes on where it stopped, the block aside
    g = torch.Generator().manual_seed(100)
    want = torch.rand(8, generator=g)
    np.testing.assert_array_equal(
        np.concatenate([out[0]["rng_default"],
                        out[0]["rng_default_after"]]), want)
    g = torch.Generator().manual_seed(100 + 1024 + 1)
    np.testing.assert_array_equal(out[1]["rng_tracked"],
                                  torch.rand(4, generator=g))
