"""Modules of the PyTorch port against the JAX package, on the CPU.

Weights cross through ``paddle1_tpu_torch.convert.state_from_jax``; the
JAX side runs its paged-attention Pallas kernel in interpret mode
(``pallas_paged_attention="always"``). Small size: ``d_model`` 128,
4 heads, vocab 64, page size 8, 2 layers, float32.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.core.tensor import to_tensor
from paddle1_tpu.nn import MultiHeadAttention as JMHA
from paddle1_tpu.serving import CausalLM as JCausalLM
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core.errors import InvalidArgumentError
from paddle1_tpu_torch.nn import MultiHeadAttention as TMHA
from paddle1_tpu_torch.nn.decode import (greedy_logits_array,
                                         sample_logits_array)
from paddle1_tpu_torch.serving import CausalLM as TCausalLM

D_MODEL, HEADS, VOCAB, PS, LAYERS, MAX_SEQ = 128, 4, 64, 8, 2, 32
MOD_TOL = dict(atol=1e-4, rtol=1e-4)


def _np_state(layer):
    return {k: np.asarray(v) for k, v in layer.functional_state().items()}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def mha_pair():
    paddle.seed(3)
    jm = JMHA(D_MODEL, HEADS)
    tm = TMHA(D_MODEL, HEADS, device="cpu")
    tm.load_state_dict(state_from_jax(_np_state(jm), tm))
    return jm, tm


@pytest.fixture(scope="module")
def lm_pair():
    paddle.seed(7)
    jl = JCausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, num_layers=LAYERS,
                   max_seq=MAX_SEQ)
    tl = TCausalLM(VOCAB, d_model=D_MODEL, nhead=HEADS, num_layers=LAYERS,
                   max_seq=MAX_SEQ, device="cpu")
    tl.load_state_dict(state_from_jax(_np_state(jl), tl))
    return jl, tl


def _paged_inputs(seed, S=3, W=1, NP=10, mpps=3):
    rng = np.random.default_rng(seed)
    hd = D_MODEL // HEADS
    x = rng.standard_normal((S, W, D_MODEL)).astype(np.float32)
    kp = rng.standard_normal((NP, PS, HEADS, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, PS, HEADS, hd)).astype(np.float32)
    table = np.zeros((S, mpps), np.int32)
    table[0, :2] = [4, 7]           # 2 live pages, rest parked
    table[1, :3] = [1, 9, 2]        # full chain
    pos = np.array([9, 17, 0], np.int32)  # slot 2 free: parked, cursor 0
    pos[1] = min(pos[1], mpps * PS - W)
    return x, kp, vp, table, pos


@pytest.mark.parametrize("w", [1, 2])
def test_mha_paged_write_and_attention_match_jax(mha_pair, w):
    jm, tm = mha_pair
    x, kp, vp, table, pos = _paged_inputs(10 + w, W=w)
    cache = JMHA.PagedCache(to_tensor(kp), to_tensor(vp), to_tensor(table),
                            to_tensor(pos))
    # no tape: the Pallas kernel has no JVP rule in interpret mode
    with jax_flags_guard(pallas_paged_attention="always"), paddle.no_grad():
        j_out, j_c = jm(to_tensor(x), None, None, None, cache)
    t_cache = TMHA.PagedCache(_t(kp), _t(vp), _t(table), _t(pos))
    with torch.no_grad():
        t_out, t_c = tm(_t(x), cache=t_cache)
    live = [0, 1]  # the parked slot's output is never read
    np.testing.assert_allclose(t_out.numpy()[live],
                               np.asarray(j_out.numpy())[live], **MOD_TOL)
    # the scatter through the page table wrote the same rows (parking
    # page 0 takes the free slot's garbage in both)
    for j, t in ((j_c.k, t_c.k), (j_c.v, t_c.v)):
        np.testing.assert_allclose(t.numpy()[1:], np.asarray(j.numpy())[1:],
                                   **MOD_TOL)
    np.testing.assert_array_equal(t_c.pos.numpy(), np.asarray(j_c.pos.numpy()))
    # the port writes in place: the returned pool IS the passed pool
    assert t_c.k is t_cache.k


def test_mha_paged_write_clamps_past_capacity(mha_pair):
    _, tm = mha_pair
    rng = np.random.default_rng(21)
    hd = D_MODEL // HEADS
    x = _t(rng.standard_normal((1, 2, D_MODEL)).astype(np.float32))
    pools = [torch.zeros(6, PS, HEADS, hd) for _ in range(2)]
    table = torch.tensor([[3, 5]], dtype=torch.int32)
    pos = torch.tensor([2 * PS - 1], dtype=torch.int32)  # row 2 overflows
    with torch.no_grad():
        _, c = tm(x, cache=TMHA.PagedCache(*pools, table, pos))
        k_new = tm.k_proj(x).reshape(1, 2, HEADS, hd)
    # both window rows clamp to the last mapped row (page 5, offset 7);
    # nothing lands outside the slot's pages
    got = c.k[5, PS - 1]
    assert torch.allclose(got, k_new[0, 0]) or \
        torch.allclose(got, k_new[0, 1])
    written = c.k.abs().sum(dim=(1, 2, 3)) > 0
    assert written.tolist() == [False, False, False, False, False, True]


def test_mha_dense_slot_cache_matches_jax(mha_pair):
    jm, tm = mha_pair
    rng = np.random.default_rng(5)
    S, M, W, hd = 3, 12, 1, D_MODEL // HEADS
    x = rng.standard_normal((S, W, D_MODEL)).astype(np.float32)
    k = rng.standard_normal((S, M, HEADS, hd)).astype(np.float32)
    v = rng.standard_normal((S, M, HEADS, hd)).astype(np.float32)
    pos = np.array([0, 5, M - 1], np.int32)
    mask = (np.arange(M)[None, None, None, :]
            <= (pos[:, None] + np.arange(W))[:, None, :, None])
    j_out, j_c = jm(to_tensor(x), None, None, to_tensor(mask),
                    JMHA.GenCache(to_tensor(k), to_tensor(v),
                                  to_tensor(pos)))
    with torch.no_grad():
        t_out, t_c = tm(_t(x), attn_mask=_t(mask),
                        cache=TMHA.GenCache(_t(k), _t(v), _t(pos)))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out.numpy()),
                               **MOD_TOL)
    np.testing.assert_allclose(t_c.k.numpy(), np.asarray(j_c.k.numpy()),
                               **MOD_TOL)
    np.testing.assert_allclose(t_c.v.numpy(), np.asarray(j_c.v.numpy()),
                               **MOD_TOL)
    np.testing.assert_array_equal(t_c.pos.numpy(), pos + W)


def test_mha_gen_caches_have_the_jax_shapes(mha_pair):
    jm, tm = mha_pair
    for j, t in ((jm.gen_slot_cache(3, 6), tm.gen_slot_cache(3, 6)),
                 (jm.gen_paged_cache(5, PS), tm.gen_paged_cache(5, PS))):
        for a, b in zip(j, t):
            assert list(a.shape) == list(b.shape)
    with pytest.raises(InvalidArgumentError):
        TMHA(10, 4, device="cpu")


def test_causal_lm_logits_match_jax(lm_pair):
    jl, tl = lm_pair
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 12))
    want = np.asarray(jl(to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tl(_t(ids)).numpy()
    np.testing.assert_allclose(got, want, **MOD_TOL)


def test_attention_ref_promotes_a_bf16_cache_like_jax():
    import jax.numpy as jnp
    from paddle1_tpu.nn.functional.attention import attention_ref as jref
    from paddle1_tpu_torch.nn.functional.attention import attention_ref
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, HEADS, 8)).astype(np.float32)
    k = rng.standard_normal((2, 5, HEADS, 8)).astype(np.float32)
    v = rng.standard_normal((2, 5, HEADS, 8)).astype(np.float32)
    mask = np.tril(np.ones((3, 5), bool), 2)[None, None]
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                           jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask)))
    got = attention_ref(_t(q), _t(k).to(torch.bfloat16),
                        _t(v).to(torch.bfloat16), _t(mask))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **MOD_TOL)


def test_causal_lm_state_names_match_jax(lm_pair):
    jl, tl = lm_pair
    assert set(tl.state_dict()) == set(jl.functional_state())
    # Paddle's Linear layout crosses untransposed
    assert tuple(tl.head.weight.shape) == (D_MODEL, VOCAB)


def test_state_from_jax_rejects_a_mismatch(lm_pair):
    jl, tl = lm_pair
    state = _np_state(jl)
    state.pop("head.bias")
    with pytest.raises(InvalidArgumentError, match="missing"):
        state_from_jax(state, tl)
    state = _np_state(jl)
    state["head.weight"] = state["head.weight"].T
    with pytest.raises(InvalidArgumentError, match="shape"):
        state_from_jax(state, tl)


def test_causal_lm_paged_decode_logits_match_jax_forward(lm_pair):
    """Prefill through the slot cache, then paged decode steps through
    the page table: each step's logits equal the JAX no-cache forward
    at that position (teacher-forced)."""
    jl, tl = lm_pair
    seq = np.random.default_rng(2).integers(0, VOCAB, 14)
    P = 6
    want = np.asarray(jl(to_tensor(seq[None])).numpy())[0]
    hd = D_MODEL // HEADS
    with torch.no_grad():
        small = [TMHA.GenCache(torch.zeros(1, 8, HEADS, hd),
                               torch.zeros(1, 8, HEADS, hd),
                               torch.zeros(1, dtype=torch.int32))
                 for _ in range(LAYERS)]
        causal = torch.ones(8, 8, dtype=torch.bool).tril()[None, None]
        ids = torch.zeros(1, 8, dtype=torch.long)
        ids[0, :P] = _t(seq[:P])
        lg, filled = tl(ids, cache=small, positions=torch.arange(8)[None],
                        attn_mask=causal)
        np.testing.assert_allclose(lg[0, :P].numpy(), want[:P], **MOD_TOL)
        table = torch.tensor([[3, 1, 4, 0]], dtype=torch.int32)
        pools = tl.gen_paged_cache(6, PS)
        for (k, v, _, _), c in zip(pools, filled):
            for i in range(P):
                k[table[0, i // PS], i % PS] = c.k[0, i]
                v[table[0, i // PS], i % PS] = c.v[0, i]
        for t in range(P, len(seq)):
            pos = torch.tensor([t], dtype=torch.int32)
            caches = [TMHA.PagedCache(k, v, table, pos)
                      for k, v, _, _ in pools]
            lg, _ = tl(_t(seq[None, t:t + 1]), cache=caches,
                       positions=pos.long()[:, None])
            np.testing.assert_allclose(lg[0, 0].numpy(), want[t], **MOD_TOL)


# ---------------------------------------------------------------------------
# sampling


def test_greedy_and_nonpositive_temperature_rows_are_argmax():
    lg = torch.tensor([[0.1, 3.0, 3.0, -1.0], [5.0, 0.0, 1.0, 2.0]])
    assert greedy_logits_array(lg).tolist() == [1, 0]  # first on ties
    assert sample_logits_array(lg, None, 0.0).tolist() == [1, 0]
    g = [torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)]
    out = sample_logits_array(lg, g, torch.tensor([0.0, -1.0]),
                              torch.tensor([2, 0]))
    assert out.tolist() == [1, 0]


def test_top_k_keeps_ties_and_masks_the_rest():
    lg = torch.tensor([[1.0, 4.0, 4.0, 4.0, 0.0, 2.0]])
    seen = set()
    for s in range(200):
        g = torch.Generator().manual_seed(s)
        seen.add(int(sample_logits_array(lg, g, 5.0, 2)[0]))
    # k=2 keeps every value >= the 2nd largest (4.0): the three tied 4s
    assert seen == {1, 2, 3}
    g = torch.Generator().manual_seed(0)
    assert int(sample_logits_array(lg, g, 1.0, 1)[0]) in (1, 2, 3)


def test_per_row_draws_depend_only_on_the_row_generator():
    rng = np.random.default_rng(0)
    lg = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    temps, topks = torch.tensor([0.9, 0.9, 0.0]), torch.tensor([0, 5, 0])

    def run(rows_seeds):
        gens = [None if s is None else torch.Generator().manual_seed(s)
                for s in rows_seeds]
        return sample_logits_array(lg, gens, temps, topks)
    a = run([11, 12, None])
    b = run([11, 99, None])
    assert a[0] == b[0]  # row 0's draw is its own generator's alone
    assert a[2] == b[2] == int(torch.argmax(lg[2]))
    assert torch.equal(run([11, 12, None]), a)  # deterministic


def test_sampling_matches_the_categorical_distribution():
    lg = torch.log(torch.tensor([[0.6, 0.3, 0.1]]))
    g = torch.Generator().manual_seed(0)
    counts = np.zeros(3)
    for _ in range(3000):
        counts[int(sample_logits_array(lg, g, 1.0, 0)[0])] += 1
    np.testing.assert_allclose(counts / counts.sum(), [0.6, 0.3, 0.1],
                               atol=0.04)
