"""Speculative decoding of the PyTorch port against the JAX package, on
the CPU (mirrors ``tests/test_generate_paged.py::TestSpeculation`` and
``::TestSpeculationParityMatrix``).

Both packages' ``CausalLM`` carry the same weights (``state_from_jax``).
Held exactly: the n-gram proposals on the same histories, and the greedy
tokens of the speculative engines (dense and paged KV, windows of 3 and
5) against the JAX package's. Sampled draws cannot match JAX's threefry
keys, so sampled speculative decode is held to the port's own contract:
bit-identical to its non-speculative decode whatever the drafts. Small
size: vocab 32, ``d_model`` 32, 2 heads, 2 layers, float32.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.serving import CausalLM as JCausalLM
from paddle1_tpu.serving import GenerationEngine as JEngine
from paddle1_tpu.serving import GenerationServer as JServer
from paddle1_tpu.serving.speculate import DraftModelSpeculator as JDraft
from paddle1_tpu.serving.speculate import NGramSpeculator as JNGram
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.ops import paged_attention as pa
from paddle1_tpu_torch.serving import (CausalLM, DraftModelSpeculator,
                                       GenerationEngine, GenerationServer,
                                       NGramSpeculator)

VOCAB, MAX_SEQ, SLOTS, PS = 32, 64, 4, 8
PROMPT = np.array([1, 2, 3, 4] * 3, np.int32)


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


@pytest.fixture(scope="module")
def dense(lm_pair):
    return GenerationEngine(lm_pair[1], slots=SLOTS, max_seq=MAX_SEQ,
                            prefill_buckets=(8, 24))


def _run(eng, prompt, steps, temperature=0.0, top_k=0, seed=1, slot=0):
    """prefill + ``steps`` one-token decode steps -> token list."""
    out = [eng.prefill(slot, np.asarray(prompt, np.int32), temperature,
                       top_k, seed)]
    active = np.zeros([eng.slots], bool)
    active[slot] = True
    for _ in range(steps):
        toks, flags = eng.decode(active)
        assert flags[slot, 0]
        out.append(int(toks[slot, 0]))
    eng.release(slot)
    return out


def _spec_run(eng, prompt, steps, temperature=0.0, top_k=0, seed=1,
              speculator=None):
    """prefill + speculative decode on slot 0 until ``steps`` generated
    tokens -> (token list, decode steps). Works on either package's
    engine (both take ``decode(active, drafts, ndrafts)``)."""
    out = [eng.prefill(0, prompt, temperature, top_k, seed)]
    sp = speculator or NGramSpeculator(prompt, eng.spec_tokens, n=3)
    sp.observe(out[0])
    active = np.zeros([eng.slots], bool)
    active[0] = True
    steps_run = 0
    while len(out) < steps + 1:
        d = sp.propose()
        drafts = np.zeros([eng.slots, eng.spec_tokens], np.int32)
        nd = np.zeros([eng.slots], np.int32)
        nd[0] = d.size
        drafts[0, :d.size] = d
        toks, flags = eng.decode(active, drafts, nd)
        steps_run += 1
        for i in range(int(flags[0].sum())):
            sp.observe(int(toks[0, i]))
            out.append(int(toks[0, i]))
    eng.release(0)
    return out[:steps + 1], steps_run


# ---------------------------------------------------------------------------
# the speculators (host code, copied): proposals equal the JAX package's


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("k,n", [(2, 3), (4, 3), (4, 1), (3, 2)])
def test_ngram_proposals_match_jax(seed, k, n):
    rng = np.random.default_rng(seed)
    # short-alphabet histories repeat grams, so most steps propose
    hist = rng.integers(0, 4 + seed % 3, 6 + seed).tolist()
    mine, ref = NGramSpeculator(hist, k, n=n), JNGram(hist, k, n=n)
    for tok in rng.integers(0, 5, 10).tolist():
        got, want = mine.propose(), ref.propose()
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
        assert mine.propose(1).tolist() == ref.propose(1).tolist()
        mine.observe(tok)
        ref.observe(tok)
    assert mine.history == ref.history


def test_draft_model_speculator_protocol_matches_jax():
    fn = lambda hist, k: hist[-1:] * (k + 2)  # noqa: E731 — over-long
    mine, ref = DraftModelSpeculator([1, 2, 3], 3, fn), JDraft([1, 2, 3],
                                                               3, fn)
    for tok in (9, 4):
        mine.observe(tok)
        ref.observe(tok)
        assert mine.propose().tolist() == ref.propose().tolist() == [tok] * 3
        assert mine.propose(2).tolist() == ref.propose(2).tolist()
    assert DraftModelSpeculator([1], 0, fn).propose().size == 0


def test_ngram_prefers_full_window():
    sp = NGramSpeculator([7, 7, 7, 7, 7, 7, 7, 7], 4, n=3)
    assert list(sp.propose()) == [7, 7, 7, 7]
    assert NGramSpeculator([1, 2, 3], 4, n=3).propose().size == 0


# ---------------------------------------------------------------------------
# the engine against the JAX package


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_greedy_speculative_tokens_match_jax(lm_pair, paged, k):
    jl, tl = lm_pair
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_buckets=(16,),
              spec_tokens=k)
    if paged:
        kw.update(paged=True, page_size=PS)
    want, jsteps = _spec_run(JEngine(jl, **kw), PROMPT, 14,
                             speculator=JNGram(PROMPT, k, n=3))
    got, steps = _spec_run(GenerationEngine(tl, **kw), PROMPT, 14)
    assert got == want
    assert steps == jsteps


def test_decode_returns_the_jax_window_shapes(lm_pair):
    jl, tl = lm_pair
    kw = dict(slots=3, max_seq=MAX_SEQ, prefill_buckets=(16,),
              spec_tokens=3)
    jeng, eng = JEngine(jl, **kw), GenerationEngine(tl, **kw)
    for e in (jeng, eng):
        e.prefill(1, PROMPT, 0.0, 0, 1)
    active = np.array([False, True, False])
    drafts = np.zeros([3, 3], np.int32)
    drafts[1] = [2, 3, 4]
    nd = np.array([0, 3, 0], np.int32)
    jt, jf = jeng.decode(active, drafts, nd)
    t, f = eng.decode(active, drafts, nd)
    assert t.shape == np.shape(jt) == (3, 4)
    assert f.shape == np.shape(jf) and f.dtype == np.asarray(jf).dtype
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(t[f], np.asarray(jt)[jf])
    assert not f[0].any() and not f[2].any()


def test_window_margin_validated_like_jax(lm_pair):
    jl, tl = lm_pair
    with pytest.raises(Exception, match="window"):
        JEngine(jl, slots=2, max_seq=4, spec_tokens=4)
    with pytest.raises(InvalidArgumentError, match="window"):
        GenerationEngine(tl, slots=2, max_seq=4, spec_tokens=4)
    with pytest.raises(InvalidArgumentError, match="spec_tokens"):
        GenerationEngine(tl, slots=2, max_seq=MAX_SEQ, spec_tokens=-1)
    eng = GenerationEngine(tl, slots=2, max_seq=16, spec_tokens=3,
                           prefill_buckets=(16,))
    assert (eng.window, eng.decode_margin) == (4, 3)
    # a prompt must leave one token of room under the margin
    with pytest.raises(InvalidArgumentError, match="margin"):
        eng.prefill(0, np.ones(13, np.int32), 0.0, 0, 1)


def test_server_streams_match_jax_under_speculation(lm_pair):
    jl, tl = lm_pair
    prompts = [list(PROMPT), [5, 6, 5, 6, 5, 6, 5], [9, 1, 8, 2], [3, 3]]
    reqs = [(p, dict(max_new_tokens=14)) for p in prompts]
    kw = dict(slots=SLOTS, max_seq=MAX_SEQ, prefill_buckets=(8, 16),
              paged=True, page_size=PS, spec_tokens=4)
    jsrv = JServer(JEngine(jl, **kw), token_budget=16).start()
    want = [s.result(timeout=120) for s in
            [jsrv.submit(p, **k) for p, k in reqs]]
    jrep = jsrv.drain()
    srv = GenerationServer(GenerationEngine(tl, **kw),
                           token_budget=16).start()
    got = [s.result(timeout=120) for s in
           [srv.submit(p, **k) for p, k in reqs]]
    snap = srv.metrics.snapshot()
    rep = srv.drain()
    assert got == want
    assert rep["tokens_generated"] == jrep["tokens_generated"]
    assert rep["unaccounted"] == 0 == jrep["unaccounted"]
    # rejected drafts' rows lie in the slot's own pages: none owed
    assert rep["kv_pages_owed"] == 0 == jrep["kv_pages_owed"]
    assert snap["counters"].get("gen_spec_proposed_total", 0) > 0
    assert "gen_spec_accept_ratio" in snap["gauges"]


# ---------------------------------------------------------------------------
# the port's own contract: speculative == non-speculative, sampled too

CASES = [(0.0, 0, 1), (0.0, 0, 7), (0.7, 4, 3), (0.7, 0, 11), (1.0, 8, 5),
         (1.3, 3, 2)]


@pytest.fixture(scope="module")
def spec_engines(lm_pair):
    return {k: GenerationEngine(lm_pair[1], slots=2, max_seq=MAX_SEQ,
                                prefill_buckets=(16,), spec_tokens=k)
            for k in (2, 4)}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("temp,top_k,seed", CASES)
def test_speculative_equals_plain_decode(dense, spec_engines, k, temp,
                                         top_k, seed):
    ref = _run(dense, PROMPT, 14, temp, top_k, seed)
    got, _ = _spec_run(spec_engines[k], PROMPT, 14, temp, top_k, seed)
    assert got == ref


@pytest.mark.parametrize("temp,top_k,seed", [(0.0, 0, 1), (0.9, 6, 4)])
def test_speculative_equals_plain_decode_over_paged_kv(lm_pair, dense, temp,
                                                      top_k, seed):
    eng = GenerationEngine(lm_pair[1], slots=2, max_seq=MAX_SEQ,
                           prefill_buckets=(16,), paged=True, page_size=PS,
                           spec_tokens=4)
    ref = _run(dense, PROMPT, 14, temp, top_k, seed)
    got, _ = _spec_run(eng, PROMPT, 14, temp, top_k, seed)
    assert got == ref
    st = eng.pool.stats()     # nothing owed (the prefix cache stays warm)
    assert st["pages_in_use"] == st["pages_cached"]


def test_own_continuation_drafts_are_all_taken(dense, spec_engines):
    """A draft model that proposes the stream's own continuation: every
    draft is accepted, a window yields k + 1 tokens, and the stream is
    still the plain one (sampled)."""
    ref = _run(dense, PROMPT, 20, 0.8, 5, 13)
    k = 4
    hist0 = len(PROMPT)
    sp = DraftModelSpeculator(
        PROMPT, k, lambda h, n: ref[len(h) - hist0:len(h) - hist0 + n])
    got, steps = _spec_run(spec_engines[k], PROMPT, 20, 0.8, 5, 13,
                           speculator=sp)
    assert got == ref
    assert steps == -(-20 // (k + 1))


def test_wrong_drafts_cost_nothing_but_width(dense, spec_engines):
    ref = _run(dense, PROMPT, 8)
    spec = spec_engines[4]
    out = [spec.prefill(0, PROMPT, 0.0, 0, 1)]
    drafts = np.full([2, 4], VOCAB - 1, np.int32)
    nd = np.array([4, 0], np.int32)
    while len(out) < 9:
        toks, flags = spec.decode(np.array([True, False]), drafts, nd)
        for i in range(int(flags[0].sum())):
            out.append(int(toks[0, i]))
    spec.release(0)
    assert out[:9] == ref


def test_repetitive_arm_accepts_and_compresses_steps():
    """On cyclic output (every weight 0: the argmax is token 0 forever)
    the n-gram drafts ride the cycle: 60 tokens in far fewer than 60
    decode steps, as in the JAX package's economics arm."""
    with torch.no_grad():
        lm = CausalLM(VOCAB, d_model=16, nhead=2, num_layers=2,
                      max_seq=256, device="cpu")
        for p in lm.parameters():
            p.zero_()
    eng = GenerationEngine(lm, slots=2, max_seq=256, prefill_buckets=(16,),
                           spec_tokens=4)
    out, steps = _spec_run(eng, PROMPT, 60)
    assert steps <= 60 / 1.8
    assert len(set(out[4:])) == 1


def test_f16_window_fits_the_kernel_at_the_readme_width():
    # D = 64, pages of 16: every window up to 1 + 4 drafts fits one CTA's
    # shared memory, f32 or f16 queries over an f16 pool
    for w in range(1, 6):
        for q_dtype in (torch.float32, torch.float16):
            assert pa.supported((16, w, 8, 64), (513, 16, 8, 64), q_dtype,
                                torch.float16)
