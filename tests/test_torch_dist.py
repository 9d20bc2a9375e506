"""Data-parallel training of the PyTorch port against the JAX package, on
the CPU.

The multi-rank cases run in gloo ranks that the port's ``spawn`` starts
(``tests/test_torch_dist_ranks.py`` holds their side), one job per world
size: each rank joins through a ``FileStore`` under the test's temporary
directory, runs single-threaded, and the job has a hard timeout. The
JAX side runs on the virtual 8-device CPU mesh of ``tests/conftest.py``:
its engine on ``build_mesh(dp=2)`` and its SyncBatchNorm under
``shard_map`` over 4 devices, with its Pallas kernels in interpret mode
where it takes them. Everything is float32 unless a case says bf16; each
tolerance is stated where it is used.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
import test_torch_dist_ranks as ranks
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.core.tensor import Tensor, to_tensor
from paddle1_tpu.nn import functional as jF
from paddle1_tpu.ops.pallas import fused_bn as jbn
from paddle1_tpu_torch import distributed as tdist
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.core.errors import (DeviceUnavailableError,
                                           ExecutionTimeoutError, FatalError,
                                           InvalidArgumentError,
                                           PreconditionNotMetError)
from paddle1_tpu_torch.nn import functional as tF
from paddle1_tpu_torch.ops import fused_bn as tbn
from paddle1_tpu_torch.optimizer import Momentum

# a whole job (rank start-up included) must end within this
JOB_TIMEOUT_S = 300
# sums over 64-128 rows in f32, in another order on each side
SUM_TOL = dict(atol=1e-4, rtol=1e-5)
# one batch norm over 4 ranks: the same sums split over ranks, and dx
# chains two of them; the one-pass variance against the JAX kernel arm's
# one-pass and its plain arm's two-pass
BN_TOL = dict(atol=1e-4, rtol=1e-4)
# three optimizer steps of a whole model: the sums above compounded
MOD_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _load(out, case, n):
    return [dict(np.load(os.path.join(out, f"{case}_rank{r}.npz")))
            for r in range(n)]


def _run_job(tmp, n, cases):
    init = tmp / f"store{n}"
    tdist.spawn(ranks.job, args=(str(tmp), str(init), cases), nprocs=n,
                timeout=JOB_TIMEOUT_S)


# ---------------------------------------------------------------------------
# (a) the moments kernel's plain version against the Pallas kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_moments_ref_and_its_grad_match_the_pallas_kernel(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((96, 16)) * 1.5 + 0.3).astype(np.float32)
    ds = rng.standard_normal(16).astype(np.float32)
    dss = rng.standard_normal(16).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    (js, jss), vjp = jax.vjp(jbn.local_moments, jx)
    jdx, = vjp((jnp.asarray(ds), jnp.asarray(dss)))
    tx = _t(x).to(getattr(torch, dtype)).requires_grad_()
    before = tbn.local_moments.launches
    ts, tss = tbn.local_moments(tx)
    tdx, = torch.autograd.grad((ts, tss), tx, (_t(ds), _t(dss)))
    assert tbn.local_moments.launches == before   # the CPU: no kernel
    assert ts.dtype == tss.dtype == torch.float32 and tdx.dtype == tx.dtype
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js),
                               **SUM_TOL)
    np.testing.assert_allclose(tss.detach().numpy(), np.asarray(jss),
                               **SUM_TOL)
    ref_s, ref_ss = tbn.local_moments_ref(tx.detach())
    assert torch.equal(ref_s, ts) and torch.equal(ref_ss, tss)
    # dx = ds + 2 x dss in f32, cast to x's dtype on both sides: equal up
    # to one rounding step of that dtype
    rel = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(tdx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=rel, atol=1e-6)


# ---------------------------------------------------------------------------
# the multi-rank jobs


@pytest.fixture(scope="module")
def r18_case(tmp_path_factory):
    """ResNet-18 with running statistics away from their init (both
    packages' weights), the global batch, and three Momentum steps of the
    JAX engine on ``build_mesh(dp=2)`` over two virtual devices."""
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh as jbuild_mesh
    from paddle1_tpu.vision.models import resnet18 as jr18
    tmp = tmp_path_factory.mktemp("r18")
    paddle.seed(19)
    jm = jr18(num_classes=10)
    rng = np.random.default_rng(19)
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    for k in state:
        if k.endswith("_mean"):
            state[k] = rng.standard_normal(state[k].shape).astype(
                np.float32) * 0.1
        elif k.endswith("_variance"):
            state[k] = rng.uniform(0.5, 1.5, state[k].shape).astype(
                np.float32)
    jm.set_state_dict({k: to_tensor(v) for k, v in state.items()})
    batch = {"x": rng.standard_normal((8, 3, 32, 32)).astype(np.float32),
             "y": rng.integers(0, 10, (8,)).astype(np.int64)}
    np.savez(tmp / "state.npz", **state)
    np.savez(tmp / "batch.npz", **batch)
    jm.train()
    jeng = JEngine(jm, paddle.optimizer.Momentum(
        learning_rate=1e-3, momentum=0.9, parameters=jm.parameters()),
        lambda m, b: jF.cross_entropy(m(Tensor(b["x"])), Tensor(b["y"])),
        mesh=jbuild_mesh(dp=2, devices=jax.devices()[:2]))
    losses = [float(jeng.step(batch)) for _ in range(ranks.STEPS)]
    return {"dir": tmp, "state": state, "batch": batch,
            "jax_losses": losses,
            "jax_params": {k: np.asarray(v) for k, v in jeng.params.items()}}


@pytest.fixture(scope="module")
def job2(tmp_path_factory, r18_case):
    """One 2-rank job: the collectives, DataParallel, the ResNet-18 engine
    steps and the unequal-shards check."""
    tmp = tmp_path_factory.mktemp("job2")
    _run_job(tmp, 2, [
        ("collectives", ()), ("data_parallel", ()),
        ("resnet_engine", (str(r18_case["dir"] / "state.npz"),
                           str(r18_case["dir"] / "batch.npz"))),
        ("unequal_shards", ()), ("place", ())])
    return str(tmp)


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    """One 4-rank job: the collectives and SyncBatchNorm."""
    tmp = tmp_path_factory.mktemp("job4")
    _run_job(tmp, 4, [("collectives", ()), ("sync_bn", ())])
    return str(tmp)


# ---------------------------------------------------------------------------
# (b) the collectives


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_over_gloo_ranks(n, job2, job4):
    out = _load(job2 if n == 2 else job4, f"collectives{n}", n)
    base = [np.arange(6, dtype=np.float32) + 10.0 * r for r in range(n)]
    total = np.sum(base, axis=0)
    for r, got in enumerate(out):
        assert got["backend_gloo"]
        np.testing.assert_array_equal(got["SUM"], total)
        np.testing.assert_allclose(got["AVG"], total / n, rtol=1e-7)
        np.testing.assert_array_equal(got["MAX"], base[-1])
        np.testing.assert_array_equal(got["MIN"], base[0])
        np.testing.assert_array_equal(got["PROD"], np.prod(base, axis=0))
        np.testing.assert_array_equal(got["broadcast"], base[-1])
        np.testing.assert_array_equal(got["all_gather"], np.stack(base))
        np.testing.assert_array_equal(got["reduce"],
                                      total if r == 1 else base[r])
        np.testing.assert_array_equal(got["pair_sum"], base[0] + base[1]
                                      if r < 2 else base[r])
        assert int(got["pair_rank"]) == (r if r < 2 else -1)


@pytest.mark.parametrize("n", [2, 4])
def test_differentiable_all_reduce_sums_forward_and_backward(n, job2, job4):
    """Rank r's loss is ``sum((r + 1) * all_reduce(x))``: the forward is
    the SUM, and every rank's x gets the gradient of the sum of all
    ranks' losses, ``sum_r (r + 1)``."""
    out = _load(job2 if n == 2 else job4, f"collectives{n}", n)
    total = np.sum([np.arange(6) + 10.0 * r for r in range(n)], axis=0)
    for got in out:
        np.testing.assert_array_equal(got["dar_y"], total)
        np.testing.assert_array_equal(got["dar_grad"],
                                      np.full(6, n * (n + 1) / 2))


# ---------------------------------------------------------------------------
# (c) SyncBatchNorm over 4 ranks against the JAX SyncBatchNorm under
# shard_map over 4 virtual devices (tests/test_fused_bn.py:280-331)


def _jax_sync_bn(fused):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle1_tpu import nn
    from paddle1_tpu.autograd import engine as ae
    from paddle1_tpu.distributed.env import spmd_axes
    x, w, b = ranks.sbn_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    sbn = nn.SyncBatchNorm(ranks.SBN_SHAPE[1])
    m0, v0 = sbn._mean.data, sbn._variance.data

    def shard_fn(xs, w_, b_):
        with warnings.catch_warnings(), ae.no_grad(), spmd_axes(dp="data"), \
                jax_flags_guard(conv_nhwc="always", fused_bn=fused,
                                fused_bn_bwd=fused), \
                sbn.load_functional_state({"weight": w_, "bias": b_,
                                           "_mean": m0, "_variance": v0}):
            # the traced statistics cannot update the buffers (warned)
            warnings.simplefilter("ignore")
            return sbn(Tensor(xs)).data

    mapped = shard_map(shard_fn, mesh=mesh, in_specs=(P("data"), P(), P()),
                       out_specs=P("data"), check_rep=False)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    y = mapped(*args)
    grads = jax.grad(lambda *a: (mapped(*a) ** 2).sum(),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("arm", ["always", "never"])
def test_sync_batch_norm_over_4_ranks_matches_jax_under_shard_map(arm,
                                                                  job4):
    """``always``: the moments and given-statistics kernels' plain
    versions, against the JAX Pallas kernels in interpret mode; ``never``:
    the plain arm against the JAX plain arm. y, dx, dgamma and dbeta
    within BN_TOL; the running statistics blend the global batch's
    (biased variance) in both packages' convention."""
    out = _load(job4, "sync_bn", 4)
    jy, (jdx, jdg, jdb) = _jax_sync_bn(arm)
    np.testing.assert_allclose(np.concatenate([o[arm + "_y"] for o in out]),
                               jy, **BN_TOL)
    np.testing.assert_allclose(np.concatenate([o[arm + "_dx"] for o in out]),
                               jdx, **BN_TOL)
    x, _, _ = ranks.sbn_inputs()
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    for o in out:
        np.testing.assert_allclose(o[arm + "_dg"], jdg, **BN_TOL)
        np.testing.assert_allclose(o[arm + "_db"], jdb, **BN_TOL)
        np.testing.assert_allclose(o[arm + "_mean"], 0.1 * mean, **BN_TOL)
        np.testing.assert_allclose(o[arm + "_var"], 0.9 + 0.1 * var,
                                   **BN_TOL)


def test_unequal_shards_raise_on_every_rank(job2):
    assert all(bool(o["raised"]) for o in _load(job2, "unequal", 2))


# ---------------------------------------------------------------------------
# (d) ResNet-18 through the dp engine on 2 ranks


def _port_engine_steps(case, flags, mesh=None):
    from paddle1_tpu_torch.vision.models import resnet18
    tm = resnet18(num_classes=10, device="cpu")
    tm.load_state_dict(state_from_jax(case["state"], tm))
    tm.train()
    eng = tdist.ParallelEngine(
        tm, Momentum(learning_rate=1e-3, momentum=0.9,
                     parameters=tm.parameters()),
        lambda m, b: tF.cross_entropy(m(b["x"]), b["y"]), mesh=mesh)
    with tflags.flags_guard(**flags):
        losses = [float(eng.step(case["batch"]))
                  for _ in range(ranks.STEPS)]
    return losses, {k: v.numpy() for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("arm", ["plain", "kernel"])
def test_resnet18_on_2_ranks_matches_the_jax_dp2_engine(arm, r18_case,
                                                        job2):
    """Three Momentum steps: losses, parameters and running statistics
    within 1e-4 of the JAX engine on a dp=2 mesh (its plain arm, the CPU
    default: GSPMD's batch norms see the global batch). Rank 1 started
    from shifted weights: rank 0's broadcast made the ranks agree, and
    they stay bit-identical."""
    out = _load(job2, "resnet_engine", 2)
    np.testing.assert_allclose(out[0][arm + "_losses"],
                               r18_case["jax_losses"], atol=1e-4, rtol=0)
    assert out[0][arm + "_losses"][-1] < out[0][arm + "_losses"][0]
    names = set(r18_case["jax_params"])
    assert {k.split(".", 1)[1] for k in out[0] if k.startswith(arm + ".")} \
        == names
    for name in names:
        key = f"{arm}.{name}"
        np.testing.assert_array_equal(out[1][key], out[0][key],
                                      err_msg=name)
        np.testing.assert_allclose(out[0][key], r18_case["jax_params"][name],
                                   err_msg=name, **MOD_TOL)
    assert bool(out[0]["indivisible_raised"]) and \
        bool(out[1]["indivisible_raised"])


@pytest.fixture(scope="module")
def r18_one_rank(r18_case):
    """The same steps on one process without a mesh, in each arm."""
    return {arm: _port_engine_steps(r18_case, flags) for arm, flags in
            (("plain", ranks.PLAIN), ("kernel", ranks.KERNELS))}


@pytest.mark.parametrize("arm", ["plain", "kernel"])
def test_resnet18_on_2_ranks_matches_one_rank_on_the_whole_batch(
        arm, r18_one_rank, job2):
    """The 2-rank steps against one process without a mesh (the whole
    batch's statistics from one rank): within 1e-4."""
    out = _load(job2, "resnet_engine", 2)
    losses, state = r18_one_rank[arm]
    np.testing.assert_allclose(out[0][arm + "_losses"], losses, atol=1e-4,
                               rtol=0)
    for name, v in state.items():
        np.testing.assert_allclose(out[0][f"{arm}.{name}"], v, err_msg=name,
                                   **MOD_TOL)


def test_dp_engine_at_world_size_1_takes_the_cross_rank_arm(
        r18_case, r18_one_rank, monkeypatch):
    """``build_mesh(dp=1)`` with no process group: every training batch
    norm runs the moments pass (its plain version here) and the
    collectives are the identity; the steps equal the engine without a
    mesh within 1e-4 (one-pass against one-pass, other sums)."""
    calls = []
    orig = tbn._moments_fwd
    monkeypatch.setattr(tbn, "_moments_fwd",
                        lambda x2: (calls.append(x2.shape), orig(x2))[1])
    losses, state = _port_engine_steps(r18_case, ranks.KERNELS,
                                       mesh=tdist.build_mesh(dp=1))
    assert len(calls) == 20 * ranks.STEPS       # ResNet-18: 20 batch norms
    ref_losses, ref_state = r18_one_rank["kernel"]
    np.testing.assert_allclose(losses, ref_losses, atol=1e-4, rtol=0)
    for name, v in ref_state.items():
        np.testing.assert_allclose(state[name], v, err_msg=name, **MOD_TOL)


# ---------------------------------------------------------------------------
# (e) DataParallel


def _whole_batch_grads(net, loss_fn):
    loss_fn(net).backward()
    return {k: p.grad.numpy() for k, p in net.named_parameters()}


def test_data_parallel_grads_on_2_ranks_equal_the_whole_batch(job2):
    """An MLP: the averaged gradients of the shards' mean losses are the
    whole batch's, with the hooks and with no_sync +
    apply_collective_grads; inside no_sync a rank keeps its own; with
    ``comm_dtype="bfloat16"`` they are averaged in bf16 and come back in
    f32 (within one bf16 rounding step of each shard's gradient)."""
    out = _load(job2, "data_parallel", 2)
    data = {k: _t(v) for k, v in ranks.dp_inputs().items()}
    want = _whole_batch_grads(ranks.mlp(), lambda m: (
        (m(data["x"]) - data["t"]) ** 2).mean())
    for o in out:
        for k, g in want.items():
            # the mean of two shard means against one mean over 8 rows
            np.testing.assert_allclose(o["mlp." + k], g, atol=1e-6,
                                       rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(o["nosync." + k], g, atol=1e-6,
                                       rtol=1e-5, err_msg=k)
            assert o["bf16comm." + k].dtype == np.float32
            np.testing.assert_allclose(o["bf16comm." + k], g,
                                       atol=2.0 ** -7 * np.abs(g).max(),
                                       rtol=2.0 ** -7, err_msg=k)
            assert not np.array_equal(o["bf16comm." + k], g)
    assert not np.allclose(out[0]["mlp_local_w"], out[1]["mlp_local_w"])


def test_data_parallel_with_sync_batch_norm_equals_the_whole_batch(job2):
    """A conv + SyncBatchNorm + ReLU under a dp binding on 2 ranks: the
    gradients and running statistics of one process's BatchNorm2D on the
    whole batch, within BN_TOL."""
    out = _load(job2, "data_parallel", 2)
    img = _t(ranks.dp_inputs()["img"])
    net = ranks.conv_bn(sync=False)
    want = _whole_batch_grads(net, lambda m: (m(img) ** 2).mean())
    for o in out:
        for k, g in want.items():
            np.testing.assert_allclose(o["conv." + k], g, err_msg=k,
                                       **BN_TOL)
        for k, t in net.named_buffers():
            np.testing.assert_allclose(o["conv." + k], t.numpy(), err_msg=k,
                                       **BN_TOL)


def test_data_parallel_is_a_passthrough_without_a_process_group():
    x = torch.randn(4, 6)
    net = ranks.mlp()
    want = torch.autograd.grad(net(x).sum(), list(net.parameters()))
    dp = tdist.DataParallel(ranks.mlp())
    got = torch.autograd.grad(dp(x).sum(), list(dp.parameters()))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert set(dp.state_dict()) == set(net.state_dict())
    zeros = {k: torch.zeros_like(v) for k, v in net.state_dict().items()}
    dp.set_state_dict(zeros)
    assert all(not p.any() for p in dp._layers.parameters())


def test_convert_sync_batchnorm_shares_weights_and_statistics():
    from paddle1_tpu_torch.nn import BatchNorm2D, SyncBatchNorm
    from paddle1_tpu_torch.vision.models import resnet18
    m = resnet18(num_classes=10, device="cpu")
    before = {k: v for k, v in m.state_dict().items()}
    bn1 = m.bn1
    out = SyncBatchNorm.convert_sync_batchnorm(m)
    assert out is m
    kinds = [type(x) for x in m.modules()
             if isinstance(x, (BatchNorm2D, SyncBatchNorm))]
    assert kinds == [SyncBatchNorm] * 20
    assert m.bn1.weight is bn1.weight and m.bn1._mean is bn1._mean
    after = m.state_dict()
    assert set(after) == set(before)
    assert all(after[k] is before[k] or torch.equal(after[k], before[k])
               for k in before)


# ---------------------------------------------------------------------------
# (f) the environment: devices, backends, meshes, spawn


def test_init_parallel_env_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        tdist.init_parallel_env()
    with pytest.raises(DeviceUnavailableError):
        tdist.init_parallel_env(device="cuda:0")
    assert not torch.distributed.is_initialized()


def test_init_parallel_env_backend_is_nccl_on_the_card_gloo_on_request(
        monkeypatch):
    """The backend follows the device: NCCL for a card (the default),
    gloo only for the CPU or when named; never a fall back."""
    from paddle1_tpu_torch.core import place as tplace
    monkeypatch.setattr(tplace._tls, "place", None, raising=False)
    seen = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: seen.append(kw))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    for var in ("PADDLE_TRAINER_ENDPOINTS", "MASTER_ADDR", "MASTER_PORT",
                "PADDLE_TRAINERS_NUM", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    tdist.init_parallel_env()
    tdist.init_parallel_env(device="cpu")
    tdist.init_parallel_env(backend="gloo")
    assert [kw["backend"] for kw in seen] == ["nccl", "gloo", "gloo"]
    assert seen[0]["world_size"] == 1 and "store" in seen[0]
    assert seen[0]["timeout"].total_seconds() == \
        tflags.flag("collective_timeout_s")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(PreconditionNotMetError, match="rendezvous"):
        tdist.init_parallel_env(device="cpu")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:6170")
    tdist.init_parallel_env(device="cpu")
    assert seen[-1]["init_method"] == "tcp://127.0.0.1:6170"


def test_layers_land_on_each_ranks_place_over_2_gloo_ranks(job2):
    # F12: on the parent, Linear(4, 6) with no device asked for the card
    # on every rank whatever init_parallel_env(device=...) chose
    for r, res in enumerate(_load(job2, "place", 2)):
        assert str(res["kind"]) == "cpu", r
        assert bool(res["on_cpu"]) and bool(res["tensor_on_cpu"]), r


@pytest.mark.parametrize("local", [0, 1])
def test_init_parallel_env_makes_the_ranks_card_the_current_place(
        monkeypatch, local):
    """F12, found in review: each rank's ``device=None`` layers went to
    card 0. ``init_parallel_env`` makes the card of the rank's local index
    the current place, as the reference's does; under a CPU place the
    rank runs on the CPU."""
    from paddle1_tpu_torch.core import place as tplace
    from paddle1_tpu_torch.core.device import resolve_device
    monkeypatch.setattr(tplace._tls, "place", None, raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: None)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(local))
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_RANK_IN_NODE", str(local))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "127.0.0.1:6170,127.0.0.1:6171")
    tdist.init_parallel_env()
    assert tplace.get_device() == tplace.CUDAPlace(local)
    assert resolve_device(None) == torch.device("cuda", local)
    tplace._tls.place = tplace.CPUPlace()
    seen = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: seen.append(kw))
    tdist.init_parallel_env()
    assert seen[0]["backend"] == "gloo"
    assert tplace.get_device() == tplace.CPUPlace()


def test_build_mesh_takes_dp_only_and_checks_the_world():
    mesh = tdist.build_mesh(dp=1)
    assert mesh.shape["dp"] == 1 and mesh.group.nranks == 1
    for kw in (dict(mp=2), dict(pp=2), dict(sharding=2), dict(sp=2)):
        with pytest.raises(InvalidArgumentError, match="4b"):
            tdist.build_mesh(**kw)
    with pytest.raises(InvalidArgumentError, match="dp=2"):
        tdist.build_mesh(dp=2)


def test_collectives_are_the_identity_on_one_rank_without_a_group():
    t = torch.arange(4.0)
    assert tdist.all_reduce(t) is t and torch.equal(t, torch.arange(4.0))
    assert tdist.differentiable_all_reduce(t) is t
    assert torch.equal(tdist.all_gather(None, t), t[None])
    g = tdist.Group(0, 2)
    with pytest.raises(PreconditionNotMetError, match="init_parallel_env"):
        tdist.all_reduce(t, group=g)


def test_spawn_stops_the_other_ranks_when_one_fails():
    import time
    t0 = time.monotonic()
    with pytest.raises(FatalError, match="rank 0 exited with code 3"):
        tdist.spawn(ranks.fail_on_rank0, nprocs=2, timeout=JOB_TIMEOUT_S)
    assert time.monotonic() - t0 < 60      # the sleeper was not waited on


def test_spawn_times_out_and_stops_its_ranks():
    with pytest.raises(ExecutionTimeoutError):
        procs = tdist.spawn(ranks.sleep_long, nprocs=2, timeout=1.0)
    procs = tdist.spawn(ranks.sleep_long, nprocs=1, join=False)
    procs[0].terminate()
    procs[0].join(10)
    assert not procs[0].is_alive()
