"""Resume replay and KV-pressure preemption of the PyTorch port against
the JAX package, on the CPU (mirrors ``tests/test_genfleet.py::
TestResumeReplayParity`` and ``::TestKVPressurePreemption``).

Held against the JAX package: greedy resumed streams and greedy streams
parked and re-admitted under ``gen_page_pressure`` chaos equal the JAX
server's, with the same drain fields. Sampled
streams are held to the port's own contract (the JAX package's threefry
draws differ): resumed == uninterrupted and parked + re-admitted ==
never parked, bit for bit. Small size: vocab 32, ``d_model`` 32, 2
heads, 2 layers, float32, 16-page pools of 8 rows.
"""

import numpy as np
import pytest

import paddle1_tpu as paddle
from paddle1_tpu.core import chaos as jchaos
from paddle1_tpu.core import health as jhealth
from paddle1_tpu.serving import CausalLM as JCausalLM
from paddle1_tpu.serving import GenerationEngine as JEngine
from paddle1_tpu.serving import GenerationServer as JServer
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import chaos
from paddle1_tpu_torch.core import health
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.serving import (CausalLM, GenerationEngine,
                                       GenerationServer, KVPoolExhausted,
                                       eager_generate)

VOCAB, MAX_SEQ, SLOTS, PS = 32, 64, 4, 8


@pytest.fixture(autouse=True)
def _isolate():
    for m in (chaos, health, jchaos, jhealth):
        m.reset()
    yield
    for m in (chaos, health, jchaos, jhealth):
        m.reset()


@pytest.fixture(scope="module")
def lm_pair():
    paddle.seed(7)
    jl = JCausalLM(VOCAB, d_model=32, nhead=2, dim_feedforward=64,
                   num_layers=2, max_seq=MAX_SEQ)
    tl = CausalLM(VOCAB, d_model=32, nhead=2, dim_feedforward=64,
                  num_layers=2, max_seq=MAX_SEQ, device="cpu")
    state = {k: np.asarray(v) for k, v in jl.functional_state().items()}
    tl.load_state_dict(state_from_jax(state, tl))
    return jl, tl


# ---------------------------------------------------------------------------
# resume replay


@pytest.mark.parametrize("spec", [0, 3])
def test_greedy_resume_matches_jax(lm_pair, spec):
    jl, tl = lm_pair
    prompt = [5, 9, 2, 7]
    kw = dict(slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=(8, 24),
              spec_tokens=spec)
    jsrv = JServer(JEngine(jl, **kw)).start()
    srv = GenerationServer(GenerationEngine(tl, **kw)).start()
    try:
        ref = jsrv.generate(prompt, max_new_tokens=12, seed=11)
        assert srv.generate(prompt, max_new_tokens=12, seed=11) == ref
        for cut in (1, 6, 11):
            want = jsrv.submit(prompt, max_new_tokens=12, seed=11,
                               resume_tokens=ref[:cut]).result(timeout=60)
            got = srv.submit(prompt, max_new_tokens=12, seed=11,
                             resume_tokens=ref[:cut]).result(timeout=60)
            assert got == want == ref[cut:], cut
    finally:
        jrep, rep = jsrv.drain(), srv.drain()
    for k in ("accepted", "completed", "tokens_generated", "unaccounted"):
        assert rep[k] == jrep[k], k


@pytest.mark.parametrize("spec", [0, 3])
@pytest.mark.parametrize("temperature,top_k", [(0.9, 8), (0.6, 0)])
def test_sampled_resume_continues_bit_identical(lm_pair, spec, temperature,
                                                top_k):
    _, tl = lm_pair
    srv = GenerationServer(GenerationEngine(
        tl, slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=(8, 24),
        spec_tokens=spec)).start()
    prompt = [5, 9, 2, 7]
    kw = dict(max_new_tokens=12, temperature=temperature, top_k=top_k,
              seed=11)
    try:
        ref = srv.generate(prompt, **kw)
        assert ref == eager_generate(tl, prompt, 12, temperature=temperature,
                                     top_k=top_k, seed=11)
        for cut in (1, len(ref) // 2, len(ref) - 1):
            st = srv.submit(prompt, resume_tokens=ref[:cut], **kw)
            assert st.result(timeout=60) == ref[cut:], cut
    finally:
        rep = srv.drain()
    assert rep["unaccounted"] == 0


def test_resume_key_depends_on_seed_and_index_only():
    k = GenerationEngine.resume_key
    assert k(11, 3) == k(11, 3)
    assert len({k(11, i) for i in range(64)}) == 64
    assert k(11, 0) != k(12, 0)
    assert 0 <= k(2 ** 40, 10 ** 9) < 2 ** 63


def test_resume_requests_are_typed_like_jax(lm_pair):
    jl, tl = lm_pair
    kw = dict(slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=(8, 24))
    jsrv = JServer(JEngine(jl, **kw)).start()
    srv = GenerationServer(GenerationEngine(tl, **kw)).start()
    try:
        for s, exc in ((jsrv, Exception), (srv, InvalidArgumentError)):
            with pytest.raises(exc, match="original seed"):
                s.submit([1, 2], max_new_tokens=8, resume_tokens=[3])
            with pytest.raises(exc, match="nothing left to generate"):
                s.submit([1, 2], max_new_tokens=3, seed=1,
                         resume_tokens=[3, 4, 5])
    finally:
        jsrv.drain()
        srv.drain()


# ---------------------------------------------------------------------------
# KV-pressure preemption (chaos squats the page pool)

PROMPTS = [[3, 1, 4, 1], [5, 9, 2, 6], [8, 2, 8, 1]]
SEEDS = [21, 22, 23]


def _preempt_run(make_engine, make_server, configure, pressure, sampled):
    configure("gen_page_pressure@3" if pressure else "")
    eng = make_engine()
    srv = make_server(eng).start()
    try:
        kw = dict(temperature=0.7, top_k=6) if sampled else {}
        streams = [srv.submit(p, max_new_tokens=16, seed=s,
                              priority=(0 if i == 0 else 2), **kw)
                   for i, (p, s) in enumerate(zip(PROMPTS, SEEDS))]
        outs = [st.result(timeout=120) for st in streams]
    finally:
        rep = srv.drain()
    assert rep["unaccounted"] == 0, rep
    assert rep["kv_pages_owed"] == 0, rep
    return outs, rep, srv.metrics.snapshot()["counters"]


def _engines(lm_pair, spec=0):
    jl, tl = lm_pair
    kw = dict(slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=(8, 24),
              paged=True, page_size=PS, pages=16, prefix_cache=0,
              spec_tokens=spec)
    return (lambda: JEngine(jl, **kw)), (lambda: GenerationEngine(tl, **kw))


def _jconf(spec):
    jchaos.reset()
    if spec:
        jchaos.configure(spec)


def _conf(spec):
    chaos.reset()
    if spec:
        chaos.configure(spec)


def test_greedy_preemption_matches_jax(lm_pair):
    jmake, make = _engines(lm_pair)
    want, jrep, jc = _preempt_run(
        jmake, lambda e: JServer(e, preempt=True), _jconf, True, False)
    got, rep, c = _preempt_run(
        make, lambda e: GenerationServer(e, preempt=True), _conf, True,
        False)
    ref, _, _ = _preempt_run(
        make, lambda e: GenerationServer(e, preempt=True), _conf, False,
        False)
    assert got == want == ref
    # how many parks it took depends on which tick the arrivals landed
    # in, in either package; both must have parked and re-admitted
    for k in ("gen_preemptions_total", "gen_preempt_readmits_total"):
        assert c.get(k, 0) >= 1 and jc.get(k, 0) >= 1, (k, c, jc)
    for k in ("accepted", "completed", "errors", "tokens_generated",
              "kv_pages_owed"):
        assert rep[k] == jrep[k], k


@pytest.mark.parametrize("spec", [0, 2])
def test_sampled_parked_and_readmitted_equals_never_parked(lm_pair, spec):
    _, make = _engines(lm_pair, spec)
    srv = lambda e: GenerationServer(e, preempt=True)  # noqa: E731
    ref, _, c0 = _preempt_run(make, srv, _conf, False, True)
    got, _, c = _preempt_run(make, srv, _conf, True, True)
    assert got == ref
    assert c0.get("gen_preemptions_total", 0) == 0
    assert c.get("gen_preemptions_total", 0) >= 1
    assert c.get("gen_preempt_readmits_total", 0) >= 1


def test_preempt_off_fails_the_faulting_stream_typed(lm_pair):
    _, make = _engines(lm_pair)
    _conf("gen_page_pressure@3")
    srv = GenerationServer(make(), preempt=False).start()
    streams = [srv.submit(p, max_new_tokens=16, seed=s)
               for p, s in zip(PROMPTS, SEEDS)]
    failed = 0
    for st in streams:
        try:
            st.result(timeout=120)
        except KVPoolExhausted:
            failed += 1
    rep = srv.drain()
    assert failed >= 1 and rep["errors"] == failed
    assert rep["unaccounted"] == 0 and rep["kv_pages_owed"] == 0


def test_a_request_larger_than_the_pool_fails_typed_under_preempt(lm_pair):
    _, tl = lm_pair
    eng = GenerationEngine(tl, slots=SLOTS, max_seq=MAX_SEQ,
                           prefill_buckets=(8, 24), paged=True,
                           page_size=PS, pages=4, prefix_cache=0)
    srv = GenerationServer(eng, preempt=True).start()
    with pytest.raises(KVPoolExhausted, match="whole pool"):
        srv.submit([1, 2, 3], max_new_tokens=40).result(timeout=60)
    rep = srv.drain()
    assert rep["errors"] == 1 and rep["unaccounted"] == 0


def test_preempt_needs_paging(lm_pair):
    _, tl = lm_pair
    eng = GenerationEngine(tl, slots=2, max_seq=MAX_SEQ,
                           prefill_buckets=(8,))
    assert not GenerationServer(eng, preempt=True).preempt
