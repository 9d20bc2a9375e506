"""The batch serving path of the PyTorch port (``InferenceEngine``,
``Batcher``/``ServeFuture``, ``Server``) against the JAX package, on the
CPU (mirrors ``tests/test_serving.py``).

Both packages serve the same MLP weights (``state_from_jax``). Held
against the JAX package: the bench's serving MLP (``bench.py``'s 512 ->
2048 -> 512 at buckets (1, 16)) served to 256 single-row requests gives
outputs within 1e-6 absolute of the JAX ``Server``'s (f32 sums in
another order; outputs are O(0.1) by the bench's design), the same
dispatch count per bucket and the same drain report; the small MLP's
outputs match to 1e-5 relative / 1e-6 absolute through every bucket. The
engine's first-forward counts stand for the JAX package's compile
counts and read the same. Admission, deadlines, chaos stalls, drain and
restart follow the JAX package's contracts.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle1_tpu as jpaddle
import paddle1_tpu_torch as paddle
from paddle1_tpu.core import chaos as jchaos
from paddle1_tpu.core import health as jhealth
from paddle1_tpu.serving import InferenceEngine as JEngine
from paddle1_tpu.serving import Server as JServer
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import chaos, health
from paddle1_tpu_torch.core.errors import (InvalidArgumentError,
                                           PreconditionNotMetError,
                                           UnimplementedError)
from paddle1_tpu_torch.core.flags import flags_guard
from paddle1_tpu_torch.serving import (DeadlineExceeded, InferenceEngine,
                                       ServeFuture, Server, ServerClosed,
                                       ServerOverloaded, resolve_buckets)


@pytest.fixture(autouse=True)
def _isolate():
    for m in (chaos, health, jchaos, jhealth):
        m.reset()
    yield
    for m in (chaos, health, jchaos, jhealth):
        m.reset()


def _pair(build_jax, build_port):
    """The JAX model and the port's twin with its weights, in eval."""
    jm = build_jax(jpaddle)
    jm.eval()
    with paddle.device_guard("cpu"), paddle.utils.unique_name.guard():
        tm = build_port(paddle)
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm.load_state_dict(state_from_jax(state, tm))
    tm.eval()
    return jm, tm


def _mlp(seed=0, din=8, dout=4):
    jpaddle.seed(seed)
    return _pair(
        lambda p: p.nn.Sequential(p.nn.Linear(din, 16), p.nn.ReLU(),
                                  p.nn.Linear(16, dout)),
        lambda p: p.nn.Sequential(p.nn.Linear(din, 16), p.nn.ReLU(),
                                  p.nn.Linear(16, dout)))


def _jax_out(model, x):
    return np.asarray(model(jpaddle.to_tensor(x)).numpy())


# ---------------------------------------------------------------------------
# the engine


def test_buckets_match_jax():
    from paddle1_tpu.serving import resolve_buckets as j_resolve
    assert resolve_buckets(None, 16) == j_resolve(None, 16) == \
        (1, 2, 4, 8, 16)
    assert resolve_buckets(None, 12) == j_resolve(None, 12)
    assert resolve_buckets((8, 1, 4, 4), None) == (1, 4, 8)
    with flags_guard(serve_buckets="2,6"):
        assert resolve_buckets(None, None) == (2, 6)
    with pytest.raises(InvalidArgumentError, match="comma-separated"):
        with flags_guard(serve_buckets="2,six"):
            resolve_buckets(None, None)
    with paddle.device_guard("cpu"):
        eng = InferenceEngine(lambda x: x, buckets=(1, 4, 8))
    assert [eng.bucket_for(r) for r in (1, 3, 8)] == [1, 4, 8]
    with pytest.raises(InvalidArgumentError, match="largest bucket"):
        eng.bucket_for(9)


def test_ragged_parity_and_one_first_forward_per_bucket():
    jm, tm = _mlp(0)
    jeng = JEngine(jm, buckets=(1, 4, 8), input_specs=[((8,), "float32")])
    eng = InferenceEngine(tm, buckets=(1, 4, 8),
                          input_specs=[((8,), "float32")])
    rng = np.random.default_rng(0)
    for rows in (1, 3, 5, 8, 3, 5, 1):  # repeats hit warm buckets
        x = rng.standard_normal((rows, 8)).astype(np.float32)
        out = eng.infer([x])[0]
        assert out.shape == (rows, 4)
        np.testing.assert_allclose(out, jeng.infer([x])[0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out, _jax_out(jm, x), rtol=1e-5,
                                   atol=1e-6)
    assert eng.compile_counts == jeng.compile_counts == {1: 1, 4: 1, 8: 1}
    assert eng.dispatch_counts == jeng.dispatch_counts
    assert eng.cache_stats() == jeng.cache_stats()


def test_warm_up_runs_one_forward_per_bucket():
    jm, tm = _mlp(1)
    jeng = JEngine(jm, buckets=(1, 2, 4), input_specs=[((8,), "float32")])
    eng = InferenceEngine(tm, buckets=(1, 2, 4),
                          input_specs=[((8,), "float32")])
    assert eng.warm_up() == jeng.warm_up() == 3
    assert eng.compile_counts == {1: 1, 2: 1, 4: 1}
    for e in (eng, jeng):
        e.infer([np.zeros((2, 8), np.float32)])
    assert eng.compile_counts[2] == 1  # served warm
    assert eng.compile_counts == jeng.compile_counts
    assert eng.cache_stats() == jeng.cache_stats()
    with pytest.raises(InvalidArgumentError, match="input_specs"):
        InferenceEngine(tm, buckets=(1,)).warm_up()


def test_retrace_guard_warns_once_on_new_inner_sig():
    import warnings
    with paddle.device_guard("cpu"):
        eng = InferenceEngine(lambda x: x * 2, buckets=(1, 4))
    eng.infer([np.zeros((1, 8), np.float32)])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng.infer([np.zeros((1, 9), np.float32)])
        eng.infer([np.zeros((1, 10), np.float32)])
    assert len([r for r in rec if "signature" in str(r.message)]) == 1


def test_pad_rows_do_not_leak_and_outputs_stay_on_the_device():
    jm, tm = _mlp(2)
    eng = InferenceEngine(tm, buckets=(8,))
    x = np.random.default_rng(1).standard_normal((3, 8)).astype(np.float32)
    outs, rows, bucket = eng.dispatch([x])
    assert (rows, bucket) == (3, 8)
    assert isinstance(outs[0], torch.Tensor) and outs[0].shape == (8, 4)
    np.testing.assert_allclose(eng.infer([x])[0], _jax_out(jm, x),
                               rtol=1e-5, atol=1e-6)


def test_param_rows_and_update_param_rows_like_jax():
    jpaddle.seed(3)
    jm, tm = _pair(lambda p: p.nn.Embedding(10, 4),
                   lambda p: p.nn.Embedding(10, 4))
    jeng, eng = JEngine(jm, buckets=(2,)), InferenceEngine(tm, buckets=(2,))
    ids = np.array([[1], [7]], np.int64)
    rows = np.arange(8, dtype=np.float32).reshape(2, 4)
    for e in (jeng, eng):
        e.update_param_rows("weight", [1, 7], rows)
    np.testing.assert_array_equal(eng.param_rows("weight", [7, 1]),
                                  jeng.param_rows("weight", [7, 1]))
    np.testing.assert_array_equal(eng.infer([ids])[0][:, 0], rows)
    for bad in (lambda e: e.update_param_rows("nope", [1], rows[:1]),
                lambda e: e.update_param_rows("weight", [1], rows),
                lambda e: e.param_rows("weight", [10])):
        with pytest.raises(Exception):
            bad(jeng)
        with pytest.raises(InvalidArgumentError):
            bad(eng)


def test_bucket_cost_names_the_queue_item():
    with paddle.device_guard("cpu"):
        eng = InferenceEngine(lambda x: x, buckets=(1,))
    with pytest.raises(UnimplementedError, match="item 9"):
        eng.bucket_cost([np.zeros((1, 2), np.float32)])


# ---------------------------------------------------------------------------
# the server against the JAX package


def test_bench_mlp_server_matches_jax():
    """The bench's serving MLP, 256 single-row requests, buckets (1, 16):
    a long batch timeout makes every micro-batch full in both packages,
    so the dispatch counts and drain reports are deterministic."""
    jpaddle.seed(0)

    def build(p):
        return p.nn.Sequential(
            p.nn.Linear(512, 2048), p.nn.ReLU(),
            p.nn.Linear(2048, 512, weight_attr=p.ParamAttr(
                initializer=p.nn.initializer.Normal(std=1e-3))))
    jm, tm = _pair(build, build)
    rng = np.random.default_rng(0)
    reqs = [rng.standard_normal((1, 512)).astype(np.float32)
            for _ in range(256)]
    outs, reps, engines = [], [], []
    for eng_cls, srv_cls, model in ((JEngine, JServer, jm),
                                    (InferenceEngine, Server, tm)):
        eng = eng_cls(model, buckets=(1, 16),
                      input_specs=[((512,), "float32")])
        eng.warm_up()
        srv = srv_cls(eng, max_batch=16, batch_timeout_ms=5000,
                      queue_depth=256 + 16).start()
        futs = [srv.submit(r) for r in reqs]
        outs.append([f.result(timeout=120) for f in futs])
        reps.append(srv.drain())
        engines.append(eng)
    err = max(float(np.abs(a - b).max()) for a, b in zip(*outs))
    assert err <= 1e-6, err
    assert engines[0].dispatch_counts == engines[1].dispatch_counts == \
        {16: 16}
    assert reps[0] == reps[1]
    assert reps[1]["unaccounted"] == 0 and reps[1]["completed"] == 256
    # the batched outputs equal the sequential ones (one request a call)
    seq = [engines[1].infer([r])[0] for r in reqs[:16]]
    assert max(float(np.abs(a - b).max())
               for a, b in zip(seq, outs[1][:16])) <= 1e-6


def test_mixed_size_parity_across_ragged_boundaries():
    jm, tm = _mlp(3)
    srv = Server(tm, max_batch=8, buckets=(1, 4, 8), batch_timeout_ms=5,
                 queue_depth=64).start()
    rng = np.random.default_rng(2)
    reqs = [rng.standard_normal((rows, 8)).astype(np.float32)
            for rows in (1, 3, 1, 2, 5, 1, 1, 4, 2, 1)]  # 21 rows
    futs = [srv.submit(r) for r in reqs]
    for r, f in zip(reqs, futs):
        out = f.result(timeout=30)
        assert out.shape == (r.shape[0], 4)
        np.testing.assert_allclose(out, _jax_out(jm, r), rtol=1e-5,
                                   atol=1e-6)
    rep = srv.drain()
    assert rep["accepted"] == 10 == rep["completed"]
    assert rep["unaccounted"] == 0
    snap = srv.metrics.snapshot()
    assert 0 < snap["histograms"]["batch_occupancy"]["max"] <= 1.0
    assert snap["counters"]["batches_total"] <= 10  # coalesced


def test_full_batch_vs_timeout_flush_paths():
    _, tm = _mlp(4)
    with flags_guard(serve_chaos_slow_s=0.4):
        chaos.configure("serve_slow_step@1")
        srv = Server(tm, max_batch=4, buckets=(1, 4), batch_timeout_ms=10,
                     queue_depth=64).start()
        x = np.zeros((1, 8), np.float32)
        first = srv.submit(x)          # batch 1: stalled by chaos
        time.sleep(0.1)                # the batcher is inside the stall
        futs = [srv.submit(x) for _ in range(4)]  # a FULL batch queues
        first.result(timeout=30)
        for f in futs:
            f.result(timeout=30)
        srv.submit(x).result(timeout=30)   # flushes on the timeout
        snap = srv.metrics.snapshot()["counters"]
        srv.drain()
    assert snap["batches_full_total"] >= 1
    assert snap["batches_timeout_total"] >= 1
    assert chaos.counts().get("serve_slow_step") >= 1


def test_incompatible_signature_splits_batch():
    _, tm = _mlp(5)
    with paddle.device_guard("cpu"):   # a callable runs on the place
        srv = Server(lambda x: x * 2, max_batch=8, buckets=(8,),
                     batch_timeout_ms=20, queue_depth=64).start()
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the expected new-signature warn
        fa = srv.submit(np.zeros((1, 8), np.float32))
        fb = srv.submit(np.ones((2, 8), np.float64))
        fa.result(timeout=30)
        np.testing.assert_array_equal(fb.result(timeout=30), 2.0)
    rep = srv.drain()
    assert rep["batches"] == 2 and rep["unaccounted"] == 0


def test_futures_share_one_readback():
    _, tm = _mlp(6)
    srv = Server(tm, max_batch=4, buckets=(4,), batch_timeout_ms=200,
                 queue_depth=8).start()
    futs = [srv.submit(np.full((1, 8), i, np.float32)) for i in range(4)]
    outs = [f.result(timeout=30) for f in futs]
    srv.drain()
    assert all(isinstance(f, ServeFuture) for f in futs)
    batch = futs[0]._batch
    assert all(f._batch is batch for f in futs)
    assert batch._device is None and len(batch._host) == 1
    assert [o.shape for o in outs] == [(1, 4)] * 4
    assert srv.metrics.snapshot()["histograms"]["readback_ms"]["count"] == 1


# ---------------------------------------------------------------------------
# admission control


def test_overload_sheds_typed():
    _, tm = _mlp(6)
    with flags_guard(serve_chaos_slow_s=0.5):
        chaos.configure("serve_slow_step@1")
        srv = Server(tm, max_batch=1, buckets=(1,), batch_timeout_ms=0,
                     queue_depth=2).start()
        x = np.zeros((1, 8), np.float32)
        first = srv.submit(x)     # picked up, stalled in dispatch
        time.sleep(0.1)
        q1, q2 = srv.submit(x), srv.submit(x)  # fill the queue
        with pytest.raises(ServerOverloaded):
            srv.submit(x)
        assert srv.metrics.snapshot()["counters"]["shed_total"] == 1
        for f in (first, q1, q2):
            f.result(timeout=30)
        rep = srv.drain()
    assert rep["accepted"] == 3 == rep["completed"]
    assert rep["unaccounted"] == 0


def test_deadline_expiry_via_slow_step_chaos():
    _, tm = _mlp(7)
    with flags_guard(serve_chaos_slow_s=0.5):
        chaos.configure("serve_slow_step@1")
        srv = Server(tm, max_batch=4, buckets=(1, 4), batch_timeout_ms=5,
                     queue_depth=64).start()
        x = np.zeros((1, 8), np.float32)
        first = srv.submit(x)  # its dispatch stalls 0.5 s
        time.sleep(0.1)
        doomed = [srv.submit(x, deadline_ms=100) for _ in range(2)]
        assert first.result(timeout=30).shape == (1, 4)
        for f in doomed:
            with pytest.raises(DeadlineExceeded, match="never"):
                f.result(timeout=30)
        rep = srv.drain()
    assert rep["deadline_failed"] == 2 and rep["accepted"] == 3
    assert rep["completed"] == 1 and rep["unaccounted"] == 0


def test_result_timeout_typed_on_wedged_batch():
    _, tm = _mlp(21)
    with flags_guard(serve_chaos_slow_s=1.0):
        chaos.configure("serve_slow_step@1")
        srv = Server(tm, max_batch=1, buckets=(1,), batch_timeout_ms=0,
                     queue_depth=8).start()
        fut = srv.submit(np.zeros((1, 8), np.float32))
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="still in flight"):
            fut.result(timeout=0.1)
        assert time.monotonic() - t0 < 0.9
        assert fut.result(timeout=30).shape == (1, 4)
        rep = srv.drain()
    assert rep["accepted"] == 1 == rep["completed"]
    assert rep["unaccounted"] == 0


def test_submit_validation_and_prebuilt_engine():
    _, tm = _mlp(8)
    srv = Server(tm, max_batch=4, buckets=(4,), batch_timeout_ms=1).start()
    with pytest.raises(InvalidArgumentError, match="split"):
        srv.submit(np.zeros((5, 8), np.float32))
    with pytest.raises(InvalidArgumentError, match="batch dim"):
        srv.submit(np.float32(3.0))
    # a torch tensor is taken as its host array
    assert srv.submit(torch.zeros(1, 8)).result(timeout=30).shape == (1, 4)
    srv.drain()
    eng = InferenceEngine(tm, buckets=(1, 4))
    with pytest.raises(InvalidArgumentError, match="pre-built"):
        Server(eng, buckets=(1, 2))
    with pytest.raises(InvalidArgumentError, match="pre-built"):
        Server(eng, input_specs=[((8,), "float32")])
    with pytest.raises(InvalidArgumentError, match="largest bucket"):
        Server(eng, max_batch=8)
    srv = Server(eng, max_batch=4)
    assert srv.engine is eng and eng.metrics is srv.metrics


def test_mismatched_multi_input_rejected_before_enqueue():
    with paddle.device_guard("cpu"):
        srv = Server(lambda x, y: x + y, max_batch=4, buckets=(4,),
                     batch_timeout_ms=5).start()
    good = (np.ones((2, 4), np.float32), np.ones((2, 4), np.float32))
    f0 = srv.submit(*good)
    with pytest.raises(InvalidArgumentError, match="share the batch"):
        srv.submit(np.ones((2, 4), np.float32), np.ones((3, 4), np.float32))
    with pytest.raises(InvalidArgumentError, match="share the batch"):
        srv.submit(np.ones((2, 4), np.float32), np.float32(1.0))
    f1 = srv.submit(*good)
    np.testing.assert_allclose(f0.result(timeout=30), 2.0)
    np.testing.assert_allclose(f1.result(timeout=30), 2.0)
    rep = srv.drain()
    assert rep["accepted"] == 2 and rep["unaccounted"] == 0


def test_submit_drain_race_accounting():
    _, tm = _mlp(13)
    eng = InferenceEngine(tm, buckets=(4,))
    x = np.zeros((1, 8), np.float32)
    for _ in range(4):
        srv = Server(eng, max_batch=4, batch_timeout_ms=1,
                     queue_depth=64).start()
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    srv.submit(x)
                except (ServerClosed, ServerOverloaded):
                    return

        ts = [threading.Thread(target=hammer) for _ in range(4)]
        for t in ts:
            t.start()
        time.sleep(0.02)
        rep = srv.drain()
        stop.set()
        for t in ts:
            t.join()
        assert rep["unaccounted"] == 0, rep


# ---------------------------------------------------------------------------
# drain


def test_health_drain_request_accounts_every_request():
    _, tm = _mlp(9)
    srv = Server(tm, max_batch=4, buckets=(1, 4), batch_timeout_ms=5,
                 queue_depth=128).start()
    x = np.zeros((1, 8), np.float32)
    futs = [srv.submit(x) for _ in range(24)]
    health.request_drain()  # the programmatic SIGTERM
    rep = srv.wait(poll_s=0.01, timeout=30)
    assert rep["drained"] is True
    assert all(f.done() for f in futs)
    assert rep["accepted"] == 24
    assert rep["completed"] + rep["deadline_failed"] + rep["errors"] == 24
    assert rep["unaccounted"] == 0
    with pytest.raises(ServerClosed):
        srv.submit(x)


def test_batcher_death_latches_drain_and_reports_fatal(monkeypatch):
    _, tm = _mlp(10)
    srv = Server(tm, buckets=(1,), batch_timeout_ms=1).start()
    from paddle1_tpu_torch.serving import batcher as batcher_mod
    real = batcher_mod.core_health

    class _BrokenHealth:  # only the BATCHER's binding is replaced
        @staticmethod
        def beat():
            raise RuntimeError("beat broke")
        report_unhealthy = staticmethod(real.report_unhealthy)
    monkeypatch.setattr(batcher_mod, "core_health", _BrokenHealth)
    rep = srv.wait(poll_s=0.01, timeout=30)  # returns via the latch
    assert rep["fatal"] is not None and "beat broke" in rep["fatal"]
    with pytest.raises(ServerClosed):
        srv.submit(np.zeros((1, 8), np.float32))


def test_drain_timeout_fails_inflight_typed():
    _, tm = _mlp(10)
    with flags_guard(serve_chaos_slow_s=1.5):
        chaos.configure("serve_slow_step@1")
        srv = Server(tm, buckets=(1,), batch_timeout_ms=1).start()
        fut = srv.submit(np.zeros((1, 8), np.float32))
        time.sleep(0.15)  # the batcher pops it and stalls in dispatch
        rep = srv.drain(timeout=0.2)
    assert rep["drained"] is False
    with pytest.raises(PreconditionNotMetError, match="timed out"):
        fut.result(timeout=1)
    assert rep["unaccounted"] == 0
    srv._batcher.join(timeout=5)


def test_sigterm_handler_installed_once_across_restarts():
    import signal
    _, tm = _mlp(10)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        srv = Server(tm, buckets=(1,), batch_timeout_ms=1)
        srv.start()
        h1 = signal.getsignal(signal.SIGTERM)
        assert getattr(h1, "_p1_serving_drain", False)
        srv.drain()
        srv.start()
        assert signal.getsignal(signal.SIGTERM) is h1
        srv.drain()
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_restart_after_drain_and_context_manager():
    _, tm = _mlp(11)
    x = np.zeros((1, 8), np.float32)
    srv = Server(tm, buckets=(1,), batch_timeout_ms=1).start()
    assert srv.infer(x, timeout=30).shape == (1, 4)
    srv.drain()
    srv.start()
    assert srv.running
    assert srv.infer(x, timeout=30).shape == (1, 4)
    assert srv.drain()["unaccounted"] == 0
    with Server(tm, buckets=(1, 2), batch_timeout_ms=1) as srv:
        assert srv.infer(x, timeout=30).shape == (1, 4)
    assert not srv.running
