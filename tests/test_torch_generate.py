"""Generative serving of the PyTorch port against the JAX package, on
the CPU.

Both ``GenerationServer``s serve the same ``CausalLM`` weights (crossed
through ``convert.state_from_jax``) in paged mode; greedy token streams
must match exactly. Sampled decode uses ``torch.Generator`` draws that
cannot match JAX's threefry keys, so it is held to the port's own
contract: alone == batched == staggered. Small size: ``d_model`` 128,
4 heads, vocab 64, page size 8, 2 layers, float32.
"""

import time

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.serving import CausalLM as JCausalLM
from paddle1_tpu.serving import GenerationEngine as JEngine
from paddle1_tpu.serving import GenerationServer as JServer
from paddle1_tpu.serving.engine import resolve_buckets as j_resolve_buckets
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.serving import (CausalLM, DeadlineExceeded,
                                       GenerationEngine, GenerationServer,
                                       KVPoolExhausted, ServerClosed,
                                       ServerOverloaded, StreamCancelled)
from paddle1_tpu_torch.serving.engine import resolve_buckets

D_MODEL, HEADS, VOCAB, PS, LAYERS, MAX_SEQ, SLOTS = 128, 4, 64, 8, 2, 32, 4
BUCKETS = (8, 16)
PROMPTS = [[1, 5, 3], [2, 2, 9, 4, 4, 7, 1, 3, 8, 6], [7, 1, 4, 9, 6],
           [3, 3]]


@pytest.fixture(scope="module")
def lm_pair():
    paddle.seed(7)
    jl = JCausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, num_layers=LAYERS,
                   max_seq=MAX_SEQ)
    tl = CausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, num_layers=LAYERS,
                  max_seq=MAX_SEQ, device="cpu")
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    tl.load_state_dict(state_from_jax(state, tl))
    return jl, tl


def _engine(lm, paged=True, **kw):
    kw.setdefault("slots", SLOTS)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_buckets", BUCKETS)
    return GenerationEngine(lm, paged=paged, page_size=PS, **kw)


def _serve(engine, **kw):
    kw.setdefault("token_budget", 12)
    return GenerationServer(engine, **kw).start()


def _staggered(srv, reqs, wait_tokens=2):
    """Submit the first half, let the running batch advance, then the
    rest; return every stream's tokens."""
    half = len(reqs) // 2
    streams = [srv.submit(p, **k) for p, k in reqs[:half]]
    t0 = time.monotonic()
    while len(streams[0].tokens) < wait_tokens and \
            not streams[0].done() and time.monotonic() - t0 < 60:
        time.sleep(0.002)
    streams += [srv.submit(p, **k) for p, k in reqs[half:]]
    return [s.result(timeout=120) for s in streams]


# ---------------------------------------------------------------------------
# against the JAX package


def test_greedy_streams_match_jax_paged_server(lm_pair):
    jl, tl = lm_pair
    reqs = [(p, dict(max_new_tokens=10)) for p in PROMPTS]
    jeng = JEngine(jl, slots=SLOTS, max_seq=MAX_SEQ,
                   prefill_buckets=BUCKETS, paged=True, page_size=PS)
    jsrv = JServer(jeng, token_budget=12).start()
    want = _staggered(jsrv, reqs)
    jrep = jsrv.drain()
    srv = _serve(_engine(tl))
    got = _staggered(srv, reqs)
    rep = srv.drain()
    assert got == want
    assert rep["unaccounted"] == 0 == jrep["unaccounted"]
    assert rep["kv_pages_owed"] == 0 == jrep["kv_pages_owed"]
    assert rep["tokens_generated"] == jrep["tokens_generated"]


def test_prefill_first_token_and_logits_match_jax(lm_pair):
    jl, tl = lm_pair
    jeng = JEngine(jl, slots=SLOTS, max_seq=MAX_SEQ,
                   prefill_buckets=BUCKETS, paged=True, page_size=PS)
    eng = _engine(tl)
    for slot, p in enumerate(PROMPTS):
        prompt = np.asarray(p, np.int32)
        assert eng.prefill(slot, prompt, 0.0, 0, 0) == \
            jeng.prefill(slot, prompt, 0.0, 0, 0)
    want = np.asarray(jl(paddle.to_tensor(
        np.asarray(PROMPTS[-1], np.int64)[None])).numpy())[0, -1]
    np.testing.assert_allclose(eng.last_prefill_logits.numpy(),
                               want, atol=1e-4, rtol=1e-4)
    for slot in range(len(PROMPTS)):
        eng.release(slot)
        jeng.release(slot)


@pytest.mark.parametrize("paged", [True, False])
def test_bf16_cache_under_f32_model_matches_jax(lm_pair, paged):
    # K/V stored in bf16 while the weights stay f32: the prefill's dense
    # attention promotes, the paged path reads the pools as f32
    jl, tl = lm_pair
    reqs = [(p, dict(max_new_tokens=8)) for p in PROMPTS]
    jeng = JEngine(jl, slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=BUCKETS,
                   paged=paged, page_size=PS, cache_dtype="bfloat16")
    jsrv = JServer(jeng, token_budget=12).start()
    want = [s.result(timeout=120) for s in
            [jsrv.submit(p, **k) for p, k in reqs]]
    jsrv.drain()
    eng = _engine(tl, paged=paged, cache_dtype=torch.bfloat16)
    assert all(k.dtype == torch.bfloat16 for k, _ in eng._kv)
    srv = _serve(eng)
    got = [s.result(timeout=120) for s in
           [srv.submit(p, **k) for p, k in reqs]]
    rep = srv.drain()
    assert got == want
    assert rep["unaccounted"] == 0 and rep["tokens_owed"] == 0


def test_resolve_buckets_matches_jax():
    for buckets, cap in ((None, 32), ((4, 8), 32), ((16, 8, 8), 16),
                         ((3,), 3)):
        assert resolve_buckets(buckets, cap) == j_resolve_buckets(
            buckets, cap, spec_flag="serve_gen_prefill_buckets")


# ---------------------------------------------------------------------------
# the port's own contracts


def test_sampled_alone_equals_batched_equals_staggered(lm_pair):
    _, tl = lm_pair
    eng = _engine(tl)
    reqs = [(PROMPTS[0], dict(max_new_tokens=8, temperature=0.9, top_k=6,
                              seed=11)),
            (PROMPTS[1], dict(max_new_tokens=8)),
            (PROMPTS[2], dict(max_new_tokens=8, temperature=0.7, seed=12)),
            (PROMPTS[3], dict(max_new_tokens=8, temperature=1.3, top_k=3,
                              seed=13))]
    alone = []
    for p, k in reqs:
        srv = _serve(eng)
        alone.append(srv.submit(p, **k).result(timeout=120))
        assert srv.drain()["unaccounted"] == 0
    srv = _serve(eng)
    batched = [s.result(timeout=120)
               for s in [srv.submit(p, **k) for p, k in reqs]]
    srv.drain()
    srv = _serve(eng)
    staggered = _staggered(srv, reqs)
    rep = srv.drain()
    assert alone == batched == staggered
    assert rep["unaccounted"] == 0 and rep["kv_pages_owed"] == 0
    # a different seed draws a different stream
    srv = _serve(eng)
    other = srv.submit(PROMPTS[0], max_new_tokens=8, temperature=0.9,
                       top_k=6, seed=99).result(timeout=120)
    srv.drain()
    assert other != alone[0]


def test_dense_and_paged_caches_serve_identical_tokens(lm_pair):
    _, tl = lm_pair
    reqs = [(p, dict(max_new_tokens=9, temperature=0.8 * (i % 2),
                     seed=i)) for i, p in enumerate(PROMPTS)]
    outs = []
    for paged in (True, False):
        srv = _serve(_engine(tl, paged=paged))
        outs.append([srv.submit(p, **k).result(timeout=120)
                     for p, k in reqs])
        rep = srv.drain()
        assert rep["unaccounted"] == 0 and rep["tokens_owed"] == 0
        assert ("kv_pages_owed" in rep) == paged
    assert outs[0] == outs[1]


def test_drain_accounting_under_load(lm_pair):
    _, tl = lm_pair
    srv = _serve(_engine(tl), queue_depth=64)
    streams = [srv.submit(PROMPTS[i % 4], max_new_tokens=3 + i % 5,
                          temperature=0.5 * (i % 2), seed=i)
               for i in range(12)]
    rep = srv.drain(timeout=120)
    assert all(s.done() for s in streams)
    assert rep["accepted"] == 12 == rep["completed"]
    assert rep["unaccounted"] == 0
    assert rep["tokens_owed"] == 0
    assert rep["kv_pages_owed"] == 0
    assert rep["decode_dispatches"] > 0
    assert sum(rep["prefill_dispatch_counts"].values()) == 12
    assert rep["tokens_generated"] == sum(len(s.tokens) for s in streams)


def test_eos_finishes_stream(lm_pair):
    _, tl = lm_pair
    srv = _serve(_engine(tl))
    probe = srv.submit(PROMPTS[0], max_new_tokens=6).result(timeout=120)
    srv.drain()
    eng = _engine(tl, eos_id=probe[2])
    srv = _serve(eng)
    st = srv.submit(PROMPTS[0], max_new_tokens=10)
    got = st.result(timeout=120)
    srv.drain()
    assert st.finish_reason == "eos"
    assert got == probe[:probe.index(probe[2]) + 1]


def test_budget_truncation_is_typed_midstream(lm_pair):
    _, tl = lm_pair
    srv = _serve(_engine(tl), token_budget=4)
    st = srv.submit(PROMPTS[0], max_new_tokens=9)
    with pytest.raises(DeadlineExceeded, match="budget"):
        st.result(timeout=120)
    rep = srv.drain()
    assert st.finish_reason == "budget" and len(st.tokens) == 4
    assert rep["deadline_failed"] == 1 and rep["unaccounted"] == 0


def test_cancel_releases_slot_and_pages(lm_pair):
    _, tl = lm_pair
    eng = _engine(tl)
    srv = _serve(eng, stream_buffer=1)
    st = srv.submit(PROMPTS[1], max_new_tokens=12)
    next(iter(st))      # one token consumed; the stream then parks
    st.cancel()
    with pytest.raises(StreamCancelled):
        st.result(timeout=120)
    rep = srv.drain()
    assert st.finish_reason == "cancelled"
    assert rep["cancelled"] == 1 and rep["unaccounted"] == 0
    assert rep["kv_pages_owed"] == 0
    assert all(not chain for chain in eng._slot_pages)


def test_backpressure_parks_slot_without_changing_tokens(lm_pair):
    _, tl = lm_pair
    eng = _engine(tl)
    srv = _serve(eng)
    want = srv.submit(PROMPTS[2], max_new_tokens=10).result(timeout=120)
    srv.drain()
    srv = _serve(eng, stream_buffer=2)
    st = srv.submit(PROMPTS[2], max_new_tokens=10)
    got = []
    for tok in st:
        got.append(tok)
        time.sleep(0.01)  # a slow reader: the slot parks between reads
    srv.drain()
    assert got == want


def test_queue_deadline_and_overload_are_typed(lm_pair):
    _, tl = lm_pair
    srv = GenerationServer(_engine(tl), queue_depth=1, token_budget=4)
    with pytest.raises(ServerClosed):
        srv.submit(PROMPTS[0])  # not started
    srv.start()
    # expired before it could be prefilled
    st = srv.submit(PROMPTS[0], max_new_tokens=2, deadline_ms=1e-6)
    with pytest.raises(DeadlineExceeded):
        st.result(timeout=120)
    rep = srv.drain()
    assert rep["deadline_failed"] == 1 and rep["unaccounted"] == 0
    with pytest.raises(ServerClosed):
        srv.submit(PROMPTS[0])
    # a full queue sheds synchronously: the loop is not running yet
    srv = GenerationServer(_engine(tl), queue_depth=1, token_budget=4)
    srv._accepting = True
    srv._loop = type("Alive", (), {"is_alive": lambda self: True,
                                   "fatal": None})()
    srv.submit(PROMPTS[0])
    with pytest.raises(ServerOverloaded):
        srv.submit(PROMPTS[1])


def test_bad_requests_are_typed(lm_pair):
    _, tl = lm_pair
    srv = _serve(_engine(tl))
    with pytest.raises(InvalidArgumentError):
        srv.submit([])
    with pytest.raises(InvalidArgumentError):
        srv.submit(list(range(MAX_SEQ + 1)))     # past every bucket
    with pytest.raises(InvalidArgumentError):
        srv.submit([1, 2], max_new_tokens=0)
    srv.drain()
    with pytest.raises(InvalidArgumentError, match="positional"):
        GenerationEngine(tl, slots=2, max_seq=MAX_SEQ * 2)
    with pytest.raises(InvalidArgumentError, match="gen_paged_cache"):
        GenerationEngine(torch.nn.Linear(2, 2), slots=2, max_seq=8,
                         paged=True)


def test_pool_exhaustion_fails_only_that_stream(lm_pair):
    _, tl = lm_pair
    # 4 usable pages: two 10-token prompts take 2 each, decode growth
    # past 16 tokens faults and the pool is dry for one of them
    eng = _engine(tl, pages=5, prefix_cache=0)
    srv = _serve(eng, token_budget=12)
    a = srv.submit(PROMPTS[1], max_new_tokens=12)
    b = srv.submit(PROMPTS[1][::-1], max_new_tokens=12)
    errs = 0
    for st in (a, b):
        try:
            st.result(timeout=120)
        except KVPoolExhausted:
            errs += 1
    rep = srv.drain()
    assert errs >= 1 and rep["errors"] == errs
    assert rep["unaccounted"] == 0 and rep["kv_pages_owed"] == 0


def test_prefix_pages_are_shared_once(lm_pair):
    _, tl = lm_pair
    eng = _engine(tl, prefix_cache=8)
    prompt = np.arange(1, 12, dtype=np.int32)  # one full page + a tail
    eng.prefill(0, prompt, 0.0, 0, 0)
    eng.prefill(1, prompt, 0.0, 0, 0)
    assert eng._slot_pages[0][0] == eng._slot_pages[1][0]  # shared head
    assert eng._slot_pages[0][1] != eng._slot_pages[1][1]  # private tail
    eng.release(0)
    eng.release(1)
    eng.check_kv_invariants()
    st = eng.pool.stats()
    assert st["pages_in_use"] == st["pages_cached"]


def test_warm_up_leaves_clean_state(lm_pair):
    _, tl = lm_pair
    eng = _engine(tl)
    assert eng.warm_up() == len(eng.prefill_buckets) + 1
    assert not eng._host_len.any() and not eng._lengths.any()
    st = eng.pool.stats()
    assert st["pages_in_use"] == 0 and st["prefix_entries"] == 0


def test_concurrent_clients_keep_accounting(lm_pair):
    """More client threads than cores submit, stream and cancel against
    one loop thread, with a short switch interval: every stream ends,
    and the drain report still balances."""
    import sys
    import threading
    _, tl = lm_pair
    # a one-token buffer parks each stream until its client reads, so a
    # cancel always lands before the stream could finish
    srv = _serve(_engine(tl), queue_depth=256, token_budget=6,
                 stream_buffer=1)
    errors = []

    def client(i):
        try:
            for j in range(2):
                st = srv.submit(PROMPTS[(i + j) % 4], max_new_tokens=6,
                                temperature=0.7 * (i % 2), seed=i * 10 + j)
                if (i + j) % 3 == 0:
                    next(iter(st))
                    st.cancel()
                    with pytest.raises(StreamCancelled):
                        st.result(timeout=120)
                else:
                    assert len(st.result(timeout=120)) == 6
        except BaseException as e:  # noqa: broad-except — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    rep = srv.drain(timeout=120)
    assert rep["accepted"] == 32
    assert rep["completed"] + rep["cancelled"] == 32
    assert rep["unaccounted"] == 0 and rep["tokens_owed"] == 0
    assert rep["kv_pages_owed"] == 0


# ---------------------------------------------------------------------------
# chaos points, the health drain, eager_generate and a float16 model
# (mirrors tests/test_generate.py::TestSlotWedgeChaos and
# ::test_wall_deadline_midstream_via_slow_step_chaos)


@pytest.fixture
def chaos_reset():
    from paddle1_tpu_torch.core import chaos, health
    chaos.reset()
    health.reset()
    yield chaos
    chaos.reset()
    health.reset()


def test_slot_wedge_fails_only_that_stream_and_releases_slot(
        lm_pair, chaos_reset):
    from paddle1_tpu_torch.serving import SlotWedged
    _, tl = lm_pair
    eng = _engine(tl, paged=False)
    srv = _serve(eng)
    ref = srv.submit(PROMPTS[0], max_new_tokens=12).result(timeout=120)
    srv.drain()
    chaos_reset.configure("gen_slot_wedge@4:1")
    srv = _serve(eng)
    a = srv.submit(PROMPTS[0], max_new_tokens=12)      # slot 0
    b = srv.submit(PROMPTS[3], max_new_tokens=12)      # slot 1: wedged
    got_a = a.result(timeout=120)
    with pytest.raises(SlotWedged):
        b.result(timeout=120)
    assert 0 < len(b.tokens) < 12  # typed MID-stream, tokens kept
    # the wedged slot was released: a follow-up request completes
    c = srv.submit([4, 4], max_new_tokens=3).result(timeout=120)
    rep = srv.drain()
    # the cohabitant is bit-identical to the uncontended run
    assert got_a == ref
    assert len(c) == 3
    assert rep["errors"] == 1 and rep["unaccounted"] == 0
    assert rep["tokens_owed"] == 0


def test_wall_deadline_midstream_via_slow_step_chaos(lm_pair, chaos_reset):
    from paddle1_tpu_torch.core.flags import flags_guard
    _, tl = lm_pair
    chaos_reset.configure("gen_slow_step@2")
    with flags_guard(serve_chaos_slow_s=0.4):
        srv = _serve(_engine(tl), token_budget=20)
        st = srv.submit([1, 2], max_new_tokens=20, deadline_ms=150)
        with pytest.raises(DeadlineExceeded, match="mid-stream"):
            st.result(timeout=120)
        rep = srv.drain()
    assert st.finish_reason == "deadline"
    assert rep["deadline_failed"] == 1 and rep["unaccounted"] == 0
    assert rep["kv_pages_owed"] == 0


def test_wait_drains_on_a_health_drain_request(lm_pair, chaos_reset):
    import threading
    from paddle1_tpu_torch.core import health
    _, tl = lm_pair
    srv = _serve(_engine(tl))
    st = srv.submit(PROMPTS[0], max_new_tokens=4)
    threading.Timer(0.2, health.request_drain).start()
    rep = srv.wait(poll_s=0.02, timeout=60)
    assert st.done() and rep["drained"]
    assert rep["completed"] == 1 and rep["unaccounted"] == 0
    with pytest.raises(ServerClosed):
        srv.submit(PROMPTS[0])


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_eager_generate_follows_the_engine(lm_pair, temperature):
    from paddle1_tpu.serving.generate import \
        eager_generate as j_eager_generate
    from paddle1_tpu_torch.serving import eager_generate
    jl, tl = lm_pair
    kw = dict(temperature=temperature, top_k=5, seed=3)
    got = eager_generate(tl, PROMPTS[1], 9, **kw)
    srv = _serve(_engine(tl))
    assert srv.generate(PROMPTS[1], max_new_tokens=9, **kw) == got
    srv.drain()
    if not temperature:   # greedy: the JAX package's tokens too
        assert got == j_eager_generate(jl, PROMPTS[1], 9, **kw)


def test_float16_model_over_a_float16_pool(lm_pair):
    """``astype("float16")`` in both packages: the port's engine serves
    the f16 model over an f16 pool (on the card: rows 1 and 2 in f16),
    and its prefill logits agree with the JAX package's f16 forward
    within f16 rounding (each matmul rounds its output: 0.05 absolute at
    these logits of magnitude <= 4)."""
    import copy
    jl, tl = lm_pair
    jl16 = copy.deepcopy(jl).astype("float16")
    tl16 = copy.deepcopy(tl).astype("float16")
    assert tl16.head.weight.dtype == torch.float16
    eng = _engine(tl16, cache_dtype="float16")
    assert all(k.dtype == torch.float16 for k, _ in eng._kv)
    srv = _serve(eng)
    outs = [srv.submit(p, max_new_tokens=6).result(timeout=120)
            for p in PROMPTS]
    rep = srv.drain()
    assert rep["unaccounted"] == 0 and rep["kv_pages_owed"] == 0
    assert all(len(o) == 6 and all(0 <= t < VOCAB for t in o) for o in outs)
    eng.prefill(0, np.asarray(PROMPTS[1], np.int32), 0.0, 0, 0)
    got = eng.last_prefill_logits.numpy()
    want = np.asarray(jl16(paddle.to_tensor(np.asarray(
        PROMPTS[1], np.int64)[None])).numpy(), np.float32)[0, -1]
    eng.release(0)
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
