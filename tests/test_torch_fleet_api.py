"""The single-process surface of slice 4b(i)-(ii) and the small names of
the port, against the JAX package on the CPU: ``DistributedStrategy`` and
``compile_strategy``, ``fleet`` at world size 1 (config 4's entry point),
the lars/lamb rewrites, LocalSGD and DGC, the RNG tracker,
``make_train_step``, the 16 top-level names, and ``read_file`` /
``decode_jpeg`` on JPEGs the JAX package's encoder writes. Inputs come
from numpy with a seed; every tolerance is stated where it is used.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core.tensor import Tensor
from paddle1_tpu_torch import distributed as tdist
from paddle1_tpu_torch.core import generator as tgen
from paddle1_tpu_torch.core.errors import (AlreadyExistsError,
                                           InvalidArgumentError,
                                           NotFoundError,
                                           PreconditionNotMetError,
                                           UnimplementedError)
from paddle1_tpu_torch.distributed import fleet as tfleet

# three AdamW steps of the tiny BERT in another order: the engine tests'
ENGINE_TOL = dict(atol=1e-4, rtol=0)
CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=16, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


@pytest.fixture
def restore_place(monkeypatch):
    from paddle1_tpu_torch.core import place
    monkeypatch.setattr(place._tls, "place", None, raising=False)


# ---------------------------------------------------------------------------
# (f) DistributedStrategy and compile_strategy


def test_distributed_strategy_fields_and_defaults_are_the_jax_packages():
    from paddle1_tpu.distributed.fleet import DistributedStrategy as JS
    j, t = JS(), tfleet.DistributedStrategy()
    assert t.to_dict() == j.to_dict()
    for s in (j, t):
        s.sharding = True
        s.sharding_configs = {"sharding_degree": 4}
        s.amp = True
    assert t.to_dict() == j.to_dict()
    assert t.sharding_configs["stage"] == 2      # a merged dict
    for s in (j, t):
        with pytest.raises(AttributeError):
            s.no_such_field = 1
        with pytest.raises(AttributeError):
            s.no_such_field
    assert repr(t) == repr(j)


def _strategies(S):
    out = []
    s = S()
    out.append(s)
    s = S()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    out.append(s)
    s = S()
    s.sharding = True
    s.sharding_configs = {"stage": 3}
    out.append(s)
    s = S()
    s.sharding = True
    s.hybrid_configs = {"dp_degree": 2}
    s.gradient_merge = True
    s.gradient_merge_configs = {"k_steps": 4}
    s.amp = True
    s.recompute = True
    s.train_steps_per_sync = 3
    out.append(s)
    s = S()
    s.tensor_parallel = True
    s.tensor_parallel_configs = {"tensor_parallel_degree": 4}
    s.pipeline = True
    s.pipeline_configs = {"accumulate_steps": 2}
    out.append(s)
    s = S()
    s.hybrid_configs = {"mp_degree": 3}
    out.append(s)
    return out


def test_compile_strategy_equals_the_jax_packages():
    from paddle1_tpu.distributed.fleet import DistributedStrategy as JS
    from paddle1_tpu.distributed.fleet import compile_strategy as jcompile
    for js, ts in zip(_strategies(JS), _strategies(tfleet.DistributedStrategy)):
        for n in (1, 4, 8):
            try:
                want = jcompile(js, n_devices=n)
            except jp.core.errors.InvalidArgumentError:
                with pytest.raises(InvalidArgumentError):
                    tfleet.compile_strategy(ts, n_devices=n)
                continue
            assert tfleet.compile_strategy(ts, n_devices=n) == want
    # the default device count is the world's
    assert tfleet.compile_strategy(tfleet.DistributedStrategy())[
        "degrees"] == {"dp": 1, "mp": 1, "pp": 1, "sharding": 1}


def test_fleet_calls_before_init_raise_and_ps_methods_name_item_8():
    fresh = type(tfleet.fleet)()
    for call in (fresh.worker_num, fresh.worker_index, fresh.is_worker,
                 fresh.get_hybrid_communicate_group,
                 lambda: fresh.distributed_model(None)):
        with pytest.raises(PreconditionNotMetError, match="fleet.init"):
            call()
    for name in ("init_server", "run_server", "save_persistables",
                 "load_persistables"):
        with pytest.raises(UnimplementedError, match="item 8"):
            getattr(fresh, name)()


def _jax_bert():
    from paddle1_tpu.text.models import BertForPretraining, BertModel
    jp.seed(0)
    jm = BertForPretraining(BertModel(**CFG))
    return {k: np.asarray(v) for k, v in jm.functional_state().items()}


def _tbert(state):
    from paddle1_tpu_torch.convert import state_from_jax
    from paddle1_tpu_torch.text.models import (BertForPretraining,
                                               BertModel)
    with tp.utils.unique_name.guard():
        tm = BertForPretraining(BertModel(device="cpu", **CFG))
    tm.load_state_dict(state_from_jax(state, tm))
    return tm


def _tloss():
    from paddle1_tpu_torch.text.models import BertPretrainingCriterion
    crit = BertPretrainingCriterion(64)

    def loss_fn(m, b):
        s, r = m(b["ids"])
        return crit(s, r, b["mlm"], b["nsp"])
    return loss_fn


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(1, 64, (8, 16)).astype(np.int32),
            "mlm": rng.integers(0, 64, (8, 16)).astype(np.int32),
            "nsp": rng.integers(0, 2, (8,)).astype(np.int32)}


def test_fleet_parallel_engine_at_world_size_1_is_config_4s_entry(
        restore_place):
    """fleet.init + apply_megatron_sharding + fleet.parallel_engine with
    ZeRO-2 and check_finite at world size 1 (every degree 1: the tags and
    the stages are the identity) takes the same steps as the plain
    engine."""
    from paddle1_tpu_torch.optimizer import AdamW
    from paddle1_tpu_torch.text.models import apply_megatron_sharding
    state = _jax_bert()
    strategy = tfleet.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 2}
    tfleet.init(is_collective=True, strategy=strategy, device="cpu")
    try:
        hcg = tfleet.get_hybrid_communicate_group()
        assert hcg.get_sharding_parallel_world_size() == 1
        assert tfleet.worker_num() == 1 and tfleet.is_first_worker()
        a = apply_megatron_sharding(_tbert(state))
        eng = tfleet.parallel_engine(a, AdamW(learning_rate=1e-3,
                                              parameters=a.parameters()),
                                     _tloss(), check_finite=True)
        assert eng.zero_stage == 2 and eng.mesh is hcg.mesh
        b = _tbert(state)
        ref = tdist.ParallelEngine(b, AdamW(learning_rate=1e-3,
                                            parameters=b.parameters()),
                                   _tloss())
        for i in range(3):
            fut = eng.step(_batch(i))
            assert not fut.bad
            np.testing.assert_allclose(float(fut), float(ref.step(_batch(i))),
                                       **ENGINE_TOL)
        for k, v in b.state_dict().items():
            np.testing.assert_allclose(a.state_dict()[k].numpy(), v.numpy(),
                                       **ENGINE_TOL)
        assert eng.slot_bytes() == 2 * 4 * sum(p.nelement()
                                               for p in a.parameters())
    finally:
        tdist.destroy_process_group()
        from paddle1_tpu_torch.distributed import topology
        topology.set_hybrid_communicate_group(None)


def test_engine_refuses_an_optimizer_clip_under_zero():
    from paddle1_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle1_tpu_torch.optimizer import AdamW
    m = torch.nn.Linear(4, 4)
    mesh = tdist.build_mesh(sharding=1)
    mesh.shape["sharding"] = 2     # a ZeRO mesh, as two ranks would see it
    with pytest.raises(InvalidArgumentError, match="clip_global_norm"):
        tdist.ParallelEngine(m, AdamW(parameters=m.parameters(),
                                      grad_clip=ClipGradByGlobalNorm(1.0)),
                             lambda mod, b: mod(b).sum(), mesh=mesh,
                             zero_stage=2)


# ---------------------------------------------------------------------------
# the optimizer rewrites, LocalSGD and DGC


def test_apply_optimizer_meta_swaps_as_the_jax_package_does():
    from paddle1_tpu.distributed.fleet.meta_optimizers import \
        apply_optimizer_meta as japply
    from paddle1_tpu_torch.distributed.fleet.meta_optimizers import \
        apply_optimizer_meta as tapply
    from paddle1_tpu_torch.optimizer import Adam, AdamW, Momentum
    w = torch.nn.Parameter(torch.ones(3))
    jw = jp.create_parameter([3], "float32")
    for field, topt, jopt in (
            ("lars", Momentum(0.1, 0.8, parameters=[w]),
             jp.optimizer.Momentum(0.1, 0.8, parameters=[jw])),
            ("lamb", Adam(0.1, parameters=[w]),
             jp.optimizer.Adam(0.1, parameters=[jw])),
            ("lars", AdamW(0.1, parameters=[w]),
             jp.optimizer.AdamW(0.1, parameters=[jw]))):
        ts, js = tfleet.DistributedStrategy(), \
            jp.distributed.fleet.DistributedStrategy()
        setattr(ts, field, True)
        setattr(js, field, True)
        got, want = tapply(topt, ts), japply(jopt, js)
        assert type(got).__name__ == type(want).__name__
        assert got.get_lr() == want.get_lr()


def test_dgc_and_local_sgd_update_as_the_jax_package():
    """Two DGC SGD steps over the same gradients: the kept top-k and the
    residual's error feedback give the JAX package's parameters (f32
    arithmetic in the same order: 1e-6); LocalSGD without a group steps
    as its inner optimizer."""
    from paddle1_tpu.core.tensor import to_tensor
    from paddle1_tpu.distributed.fleet import DGCMomentumOptimizer as JDGC
    from paddle1_tpu_torch.optimizer import SGD
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32)
             for _ in range(2)]
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    jw = jp.create_parameter([4, 5], "float32")
    jw.set_value(w0)
    topt = tfleet.DGCMomentumOptimizer(SGD(0.5, parameters=[tw]),
                                       sparsity=0.25, momentum=0.9)
    jopt = JDGC(jp.optimizer.SGD(0.5, parameters=[jw]), sparsity=0.25,
                momentum=0.9)
    for g in grads:
        tw.grad = torch.from_numpy(g.copy())
        jw.grad = to_tensor(g)
        topt.step()
        jopt.step()
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.numpy()),
                                   atol=1e-6, rtol=0)
    lw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    local = tfleet.LocalSGDOptimizer(SGD(0.5, parameters=[lw]), k_steps=1)
    lw.grad = torch.from_numpy(grads[0].copy())
    local.step()
    np.testing.assert_allclose(lw.detach().numpy(), w0 - 0.5 * grads[0],
                               atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# (e) the RNG tracker


def test_rng_tracker_semantics():
    tgen.seed(3)
    tracker = tgen.get_rng_tracker()
    tracker.add("a", 11)
    with pytest.raises(AlreadyExistsError, match="already exists"):
        tracker.add("a", 12)
    with pytest.raises(AlreadyExistsError, match="seed 11"):
        tracker.add("b", 11)
    with pytest.raises(NotFoundError):
        with tracker.rng_state("nope"):
            pass
    tracker.add("b", 12)
    first = torch.rand(3)
    with tracker.rng_state("a"):
        a1 = torch.rand(2)
    with tracker.rng_state("b"):
        b1 = torch.rand(2)
    with tracker.rng_state("a"):
        a2 = torch.rand(2)       # the stream goes on where it stopped
    second = torch.rand(3)
    g = torch.Generator().manual_seed(11)
    np.testing.assert_array_equal(torch.cat([a1, a2]),
                                  torch.rand(4, generator=g))
    np.testing.assert_array_equal(b1, torch.rand(
        2, generator=torch.Generator().manual_seed(12)))
    g = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(torch.cat([first, second]),
                                  torch.rand(6, generator=g))
    tgen.seed(4)                 # reseeding drops every stream
    with pytest.raises(NotFoundError):
        with tracker.rng_state("a"):
            pass
    tgen.seed(0)
    from paddle1_tpu_torch.distributed.meta_parallel import (
        get_rng_state_tracker, model_parallel_random_seed)
    model_parallel_random_seed(7)
    assert get_rng_state_tracker() is tracker
    with tracker.rng_state():
        mp0 = torch.rand(2)
    np.testing.assert_array_equal(mp0, torch.rand(
        2, generator=torch.Generator().manual_seed(7 + 1024)))
    tgen.seed(0)


# ---------------------------------------------------------------------------
# make_train_step


def test_make_train_step_is_the_engines_step_as_a_pure_function():
    from paddle1_tpu_torch.optimizer import AdamW
    state = _jax_bert()
    a, b = _tbert(state), _tbert(state)
    opt = AdamW(learning_rate=1e-3, parameters=a.parameters())
    step = tdist.make_train_step(a, opt, _tloss(), clip_global_norm=0.5,
                                 check_finite=True)
    params = {k: v.detach().clone() for k, v in a.named_parameters()}
    before = {k: v.clone() for k, v in params.items()}
    opt_state = opt.functional_init(params)
    eng = tdist.ParallelEngine(b, AdamW(learning_rate=1e-3,
                                        parameters=b.parameters()),
                               _tloss(), clip_global_norm=0.5,
                               check_finite=True)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        out, params, opt_state = step(params, opt_state, batch, None, 1e-3)
        fut = eng.step(_batch(i))
        np.testing.assert_allclose(out.numpy(), fut.tensor.numpy(),
                                   **ENGINE_TOL)
    for k, p in b.named_parameters():
        np.testing.assert_allclose(params[k].numpy(), p.detach().numpy(),
                                   **ENGINE_TOL)
    for k, v in a.named_parameters():      # the inputs are not written
        assert torch.equal(v.detach(), before[k])
    # a non-finite step keeps every input
    poisoned = dict(params)
    key = "cls.transform.bias"
    poisoned[key] = poisoned[key] * float("nan")
    batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    out, kept, kept_state = step(poisoned, opt_state, batch, None, 1e-3)
    assert float(out[1]) == 1.0
    for k, v in kept.items():
        assert torch.equal(v, poisoned[k]) or k == key
    assert int(kept_state[1]) == int(opt_state[1])
    with pytest.raises(UnimplementedError, match="GSPMD"):
        tdist.make_train_step(a, opt, _tloss(), grad_shardings={})


# ---------------------------------------------------------------------------
# (j) the top-level names


def test_the_sixteen_top_level_names(restore_place):
    for name in ("bool", "VarBase", "batch", "Place", "TPUPlace",
                 "CUDAPinnedPlace", "NPUPlace", "XPUPlace",
                 "is_compiled_with_xpu", "is_compiled_with_npu",
                 "get_cudnn_version", "device_count", "is_compiled_with_tpu",
                 "enable_dygraph", "disable_dygraph", "disable_static"):
        assert hasattr(jp, name) and hasattr(tp, name), name
    assert tp.bool is torch.bool and str(jp.bool) == "bool"
    x = tp.to_tensor([0.0, 2.0], place="cpu")
    assert x.astype(tp.bool).tolist() == [False, True]
    assert tp.VarBase is tp.Tensor and jp.VarBase is jp.Tensor
    assert issubclass(tp.TPUPlace, tp.Place) and \
        tp.TPUPlace(1) == tp.CUDAPlace(1)
    assert isinstance(tp.CPUPlace(), tp.Place)
    assert repr(tp.CUDAPinnedPlace()) == repr(jp.CUDAPinnedPlace())
    for cls in ("NPUPlace", "XPUPlace"):
        for pkg in (jp, tp):
            with pytest.raises(RuntimeError):
                getattr(pkg, cls)(0)
    for pkg in (jp, tp):
        assert pkg.is_compiled_with_xpu() is False
        assert pkg.is_compiled_with_npu() is False
        assert pkg.enable_dygraph() is None and pkg.disable_static() is None
        with pytest.raises(RuntimeError, match="static graph"):
            pkg.disable_dygraph()

    def reader():
        yield from range(7)
    for drop in (False, True):
        assert list(tp.batch(reader, 3, drop)()) == \
            list(jp.batch(reader, 3, drop)())
    # the accelerator questions answer for the card (departures by design,
    # ROADMAP Queue 3): cuDNN's version where torch has cuDNN, the cards
    # (or the CPU's one device) and whether a card is there
    cudnn = torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None
    assert tp.get_cudnn_version() == cudnn and jp.get_cudnn_version() is None
    assert tp.device_count() == (torch.cuda.device_count() or 1)
    assert tp.is_compiled_with_tpu() is torch.cuda.is_available()


# ---------------------------------------------------------------------------
# (i) read_file and decode_jpeg


@pytest.mark.parametrize("channels,quality", [(3, 92), (1, 75), (3, 50)])
def test_decode_jpeg_is_bit_equal_to_the_jax_packages(tmp_path, channels,
                                                     quality, restore_place):
    from paddle1_tpu.core.jpeg import encode_jpeg_bytes
    from paddle1_tpu.vision.ops import decode_jpeg as jdecode
    from paddle1_tpu.vision.ops import read_file as jread
    rng = np.random.default_rng(channels * 100 + quality)
    h, w = 24 + channels, 40 - channels
    img = (rng.random((h, w, channels)) * 255).astype(np.uint8)
    img[::3] //= 2           # some structure, so blocks differ
    p = tmp_path / f"img{channels}_{quality}.jpg"
    p.write_bytes(encode_jpeg_bytes(img, quality=quality))
    tp.set_device("cpu")
    raw = tp.vision.ops.read_file(str(p))
    assert raw.dtype == torch.uint8 and raw.dim() == 1
    np.testing.assert_array_equal(raw.numpy(), np.asarray(
        jread(str(p)).numpy()))
    for mode in ("unchanged", "gray"):
        got = tp.vision.ops.decode_jpeg(raw, mode=mode)
        want = np.asarray(jdecode(jread(str(p)), mode=mode).numpy())
        assert got.dtype == torch.uint8 and got.device.type == "cpu"
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(tp.vision.ops.decode_jpeg(raw).shape) == (channels, h, w)


# ---------------------------------------------------------------------------
# the name sweep: what distributed and fleet still lack are later items'


def test_distributed_and_fleet_lack_only_the_names_of_later_items():
    import paddle1_tpu.distributed as jd
    import paddle1_tpu.distributed.fleet as jf
    later = {
        # item 6: resilience
        "resilience", "ResilientTrainer", "ResilienceReport",
        "BadStepError",
        # item 8: the parameter server, the embedding services and their
        # file datasets and admission entries
        "ps", "SparseTable", "DenseTable", "EmbeddingService",
        "DistributedEmbedding", "ps_server", "TableServer", "RemoteTable",
        "remote_service", "communicator", "AsyncCommunicator",
        "GeoCommunicator", "SparseAsyncCommunicator", "DenseEndpoint",
        "graph_table", "GraphTable", "HBMShardedEmbedding", "hash_bucket",
        "embedding_engine", "ShardedEmbeddingEngine", "embedding_delta",
        "DeltaLog", "DeltaRecord", "DeltaSubscriber", "InMemoryDataset",
        "QueueDataset", "CountFilterEntry", "ProbabilityEntry"}
    missing = {n for n in jd.__all__ if not hasattr(tdist, n)}
    assert missing == later
    fleet_later = {
        # items 8 and 10: the trainers, data generators, file datasets
        # and the PS utility
        "fleet_util", "UtilBase", "DataGenerator", "MultiSlotDataGenerator",
        "MultiSlotStringDataGenerator", "data_generator", "DatasetBase",
        "InMemoryDataset", "QueueDataset", "HogwildWorker", "InferWorker",
        "MultiTrainer", "TrainerDesc", "DeviceWorkerDesc", "create_trainer",
        "ProcessMultiTrainer", "process_trainer", "trainer"}
    public = {n for n in dir(jf) if not n.startswith("_")}
    assert {n for n in public if not hasattr(tfleet, n)} == fleet_later
