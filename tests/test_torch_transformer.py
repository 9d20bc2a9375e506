"""The encoder-decoder ``nn.Transformer`` path against the JAX package on
the CPU: ``chip_smoke.py``'s translation script (shared embedding scaled
by sqrt(d_model) with sinusoidal positions, ``nn.Transformer``, the tied
output projection, label-smoothed soft-label cross entropy, Adam on the
Noam schedule, beam search through ``nn.BeamSearchDecoder`` and
``nn.dynamic_decode``) run by both packages at a narrow size: d_model 32,
4 heads, 2 + 2 layers, feed-forward 64, vocabulary 50, the JAX package's
seeded weights carried across by ``convert.state_from_jax``.

Tolerances (f32): the forward within 1e-5, the gradients and three
optimizer steps within 1e-4 (the attention key biases, whose gradient is
0 in exact arithmetic and which Adam moves by rounding noise, within
steps x lr), the incremental decode within 1e-5 of the full forward, and
the greedy and beam-search token ids exactly. The layers' inventory,
positional signatures, caches and attention routing are here too.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.ops import flash_attention as tfa
from paddle1_tpu_torch.core import flags as tflags

NARROW = dict(vocab=50, d_model=32, nhead=4, enc_layers=2, dec_layers=2,
              ffn=64)
FWD_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-4
# the test's schedule: Noam at d_model 32 with 40 warm-up steps, so that
# three steps move the weights (lr 7e-4 x step)
WARMUP = 40


@pytest.fixture(autouse=True)
def cpu_place():
    with tp.device_guard("cpu"):
        yield


def _pair(dropout=0.0, seed=0):
    """The narrow model in both packages, the port's carrying the JAX
    package's weights."""
    from paddle1_tpu.nn import layer_base as jlb
    from paddle1_tpu_torch.nn import layer_base as tlb
    jp.seed(seed)
    saved = [dict(m._global_layer_name_counts) for m in (jlb, tlb)]
    jm = cs.s2s_model(jp, dropout=dropout, **NARROW)
    with tp.utils.unique_name.guard():
        tm = cs.s2s_model(tp, dropout=dropout, **NARROW)
    for m, old in zip((jlb, tlb), saved):
        m._global_layer_name_counts.clear()
        m._global_layer_name_counts.update(old)
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    tm.load_state_dict(state_from_jax(state, tm))
    return jm, tm


def _batches(pkg, model, buckets=((3, 8, 6), (2, 12, 6)), seed=5):
    rng = np.random.default_rng(seed)
    return [cs.s2s_batch(pkg, model, rng, b, ns, nt, NARROW["vocab"])
            for b, ns, nt in buckets]


def _np(t):
    return t.detach().cpu().numpy() if type(t) is torch.Tensor else \
        np.asarray(t.numpy())


def test_every_transformer_name_is_ported_with_the_reference_signature():
    jm = importlib.import_module("paddle1_tpu.nn.layer_transformer")
    tm = importlib.import_module("paddle1_tpu_torch.nn.layer_transformer")
    assert set(jm.__all__) <= set(tm.__all__)
    for name in jm.__all__:
        assert hasattr(tp.nn, name)
        for meth in ("__init__", "forward", "gen_cache"):
            jf = getattr(getattr(jm, name), meth, None)
            if jf is None:
                continue
            tf = getattr(getattr(tm, name), meth)
            want = [p for p in inspect.signature(jf).parameters]
            got = [n for n, p in inspect.signature(tf).parameters.items()
                   if p.kind != p.KEYWORD_ONLY]
            assert got == want, (name, meth)
    assert tp.nn.MultiHeadAttention.Cache._fields == ("k", "v")
    assert tp.nn.MultiHeadAttention.StaticCache._fields == ("k", "v")


def test_forward_and_gradients_match_the_reference():
    jm, tm = _pair()
    (jb,), (tb,) = _batches(jp, jm, ((3, 8, 6),)), \
        _batches(tp, tm, ((3, 8, 6),))
    jl = jm(jb["src"], jb["tgt_in"], jb["src_mask"], jb["tgt_mask"])
    tl = tm(tb["src"], tb["tgt_in"], tb["src_mask"], tb["tgt_mask"])
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=FWD_TOL, atol=FWD_TOL)
    jloss = cs.s2s_loss(jp, jl, jb["tgt_out"], NARROW["vocab"])
    tloss = cs.s2s_loss(tp, tl, tb["tgt_out"], NARROW["vocab"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=FWD_TOL)
    jloss.backward()
    tloss.backward()
    jg = {n: p.grad for n, p in jm.named_parameters()}
    tg = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(jg) == sorted(tg)
    for n, g in jg.items():
        assert (g is None) == (tg[n] is None), n
        np.testing.assert_allclose(_np(tg[n]), _np(g), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)


def test_three_label_smoothed_adam_noam_steps_match_the_reference():
    jm, tm = _pair()
    steps = {}
    for pkg, m in ((jp, jm), (tp, tm)):
        opt, sched = cs.s2s_optimizer(pkg, m, NARROW["d_model"], WARMUP)
        step = cs.s2s_step_fn(pkg, m, opt, sched, _batches(pkg, m),
                              amp=False, vocab=NARROW["vocab"])
        steps[pkg.__name__] = ([float(step()) for _ in range(3)],
                               sched.last_epoch, sched())
    (jl, je, jlr), (tl, te, tlr) = steps["paddle1_tpu"], \
        steps["paddle1_tpu_torch"]
    np.testing.assert_allclose(tl, jl, rtol=STEP_TOL, atol=STEP_TOL)
    assert te == je and tlr == pytest.approx(jlr, rel=1e-12)
    lrs = [NARROW["d_model"] ** -0.5 * s * WARMUP ** -1.5
           for s in (1, 2, 3)]
    tp_state = {n: _np(p) for n, p in tm.named_parameters()}
    for n, p in jm.named_parameters():
        tol = sum(lrs) if n.endswith("k_proj.bias") else STEP_TOL
        np.testing.assert_allclose(tp_state[n], _np(p), rtol=STEP_TOL,
                                   atol=tol, err_msg=n)


def test_incremental_cache_decode_equals_the_full_forward():
    """Step by step through ``gen_cache`` (Cache and StaticCache), each
    step's output equals the full causal forward's row, in both
    packages."""
    for pkg in (jp, tp):
        m = (_pair()[0] if pkg is jp else _pair()[1])
        m.eval()
        b = _batches(pkg, m, ((2, 8, 5),))[0]
        dec = m.transformer.decoder
        memory = m.transformer.encoder(m.embed(b["src"]), b["src_mask"])
        full = _np(dec(m.embed(b["tgt_in"]), memory, b["tgt_mask"],
                       b["src_mask"]))
        caches = dec.gen_cache(memory)
        assert isinstance(caches[0][0], pkg.nn.MultiHeadAttention.Cache)
        assert isinstance(caches[0][1],
                          pkg.nn.MultiHeadAttention.StaticCache)
        assert list(caches[0][0].k.shape) == [2, 0, 4, 8]
        rows = []
        for t in range(5):
            x = m.embed(b["tgt_in"][:, t:t + 1], start=t)
            h, caches = dec(x, memory, None, b["src_mask"], caches)
            rows.append(_np(h)[:, 0])
        assert list(caches[1][0].k.shape) == [2, 5, 4, 8]
        np.testing.assert_allclose(np.stack(rows, 1), full, rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=pkg.__name__)
        zipped = dec.gen_cache(memory, do_zip=True)
        assert len(zipped) == 2 and len(zipped[0]) == 2


def test_concatenated_cache_dtype_under_auto_cast_is_the_reference_s():
    got = {}
    for pkg, m in zip((jp, tp), _pair()):
        m.eval()
        attn = m.transformer.decoder.layers[0].self_attn
        x = pkg.to_tensor(np.random.default_rng(1).standard_normal(
            (2, 1, 32)).astype(np.float32))
        cache = attn.gen_cache(x)
        with pkg.amp.auto_cast():
            q, k, v, cache = attn._prepare_qkv(x, x, x, cache)
        got[pkg.__name__] = (str(cache.k.dtype).split(".")[-1],
                             str(q.dtype).split(".")[-1],
                             str(attn.gen_cache(x).k.dtype).split(".")[-1])
    assert got["paddle1_tpu_torch"] == got["paddle1_tpu"]
    assert got["paddle1_tpu_torch"] == ("float32", "bfloat16", "float32")


def _jax_merge_with_sizes(monkeypatch):
    """The JAX package's beam merge and split, ``reshape((-1,) + ...)``,
    raise on the empty ``Cache`` of the first step (``[B, beam, 0, heads,
    dim]``: no -1 to infer; ``paddle1_tpu/nn/decode.py:173-179``, a fault
    of the reference, ROADMAP Queue 3). Here they take explicit sizes, as
    the port's do; nothing else of the reference changes."""
    from paddle1_tpu.autograd.engine import apply
    from paddle1_tpu.nn.decode import BeamSearchDecoder as J

    def split(self, x):
        return apply("split_batch_beams", lambda a: a.reshape(
            (a.shape[0] // self.beam_size, self.beam_size) + a.shape[1:]),
            (x,))

    def merge(self, x):
        return apply("merge_batch_beams", lambda a: a.reshape(
            (a.shape[0] * a.shape[1],) + a.shape[2:]), (x,))
    monkeypatch.setattr(J, "_split_batch_beams", split)
    monkeypatch.setattr(J, "_merge_batch_beams", merge)


def test_the_reference_beam_merge_raises_on_an_empty_cache():
    from paddle1_tpu.nn.decode import BeamSearchDecoder as J
    dec = J(None, 1, 2, 4)
    with pytest.raises(Exception):
        dec._merge_batch_beams(jp.to_tensor(np.zeros((2, 4, 0, 3),
                                                     np.float32)))
    got = tp.nn.BeamSearchDecoder(None, 1, 2, 4)._merge_batch_beams(
        torch.zeros(2, 4, 0, 3))
    assert list(got.shape) == [8, 0, 3]


@pytest.mark.parametrize("beam", [1, 4], ids=["greedy", "beam4"])
def test_decoded_token_ids_equal_the_reference_s(beam, monkeypatch):
    _jax_merge_with_sizes(monkeypatch)
    jm, tm = _pair(seed=3)
    out = {}
    for pkg, m in ((jp, jm), (tp, tm)):
        b = _batches(pkg, m, ((3, 8, 6),), seed=7)[0]
        ids = cs.s2s_decode(pkg, m, b["src"], b["src_mask"], beam=beam,
                            max_step_num=9)
        out[pkg.__name__] = _np(ids)
    want, got = out["paddle1_tpu"], out["paddle1_tpu_torch"]
    assert got.shape == want.shape
    assert got.shape[:2] == (3, 10) and (beam == 1 or got.shape[2] == 4)
    np.testing.assert_array_equal(got, want)


def _trace(steps):
    """A beam-search trace of one sentence: each step's ranked candidates,
    ``(scores, flat indices)`` of ``[1, n]``."""
    return [(torch.tensor([sc], dtype=torch.float32), torch.tensor([ix]))
            for sc, ix in steps]


def test_beam_divergence_names_the_swapped_candidates_and_their_gaps():
    # beam 2 over a vocabulary of 10: the paths agree at step 0 (scores
    # 2e-4 apart), and at step 1 rank 1 the kernel path takes token 5 of
    # beam 0 and the plain path token 2, each 1e-4 ahead of the other's;
    # the kernel path's next candidate lies outside the plain path's best 4
    tk = _trace([([-1.0, -1.5, -2.0, -3.0], [3, 7, 12, 4]),
                 ([-2.0, -2.3, -2.3001, -4.0], [13, 5, 2, 9])])
    tp_ = _trace([([-1.0, -1.5002, -2.0, -3.0], [3, 7, 12, 4]),
                  ([-2.0, -2.3, -2.3001, -4.0], [13, 2, 5, 8])])
    d = cs.beam_divergence(tk, tp_, 2, vocab=10)
    assert (d["step"], d["sentence"], d["rank"]) == (1, 0, 1)
    assert d["kernel_choice"] == [0, 5] and d["plain_choice"] == [0, 2]
    assert d["gap_kernel"] == pytest.approx(1e-4, abs=1e-6)
    assert d["gap_plain"] == pytest.approx(1e-4, abs=1e-6)
    assert d["score_err_before"] == pytest.approx(2e-4, abs=1e-6)
    # the kernel path's choice ranks outside the plain path's best 2 x beam
    tp_far = _trace([([-1.0, -1.5, -2.0, -3.0], [3, 7, 12, 4]),
                     ([-2.0, -2.3, -2.5, -4.0], [13, 2, 8, 9])])
    far = cs.beam_divergence(tk, tp_far, 2, vocab=10)
    assert far["gap_kernel"] == pytest.approx(1e-4, abs=1e-6)
    assert far["gap_plain"] is None
    assert cs.beam_divergence(tk, tk, 2, vocab=10) is None


def test_traced_beam_decoder_records_the_decoder_s_ranked_candidates():
    _, tm = _pair(seed=3)
    b = _batches(tp, tm, ((3, 8, 6),), seed=7)[0]
    traces = [[], []]
    for tr in traces:
        ids = cs.s2s_decode(tp, tm, b["src"], b["src_mask"], beam=4,
                            max_step_num=5,
                            beam_decoder=cs.traced_beam_decoder(tp, tr))
    assert len(traces[0]) == ids.shape[1] == 6
    for sc, ix in traces[0]:
        assert list(sc.shape) == list(ix.shape) == [3, 8]
        assert bool((sc[:, :-1] >= sc[:, 1:]).all())
    assert cs.beam_divergence(*traces, 4, vocab=NARROW["vocab"]) is None


def test_relu_kink_replay_takes_the_recorded_sides_call_by_call():
    """``chip_smoke.ActPieces`` on the Transformer layers' ReLU (as the
    f32 check installs it): a replay on the recorded sides, two buckets'
    calls each, reproduces the recorded run's gradients; a replay on the
    opposite sides flips every element and changes them."""
    import copy
    _, tm = _pair(seed=4)
    tr = tm.transformer
    for layer in (*tr.encoder.layers, *tr.decoder.layers):
        layer.activation = tp.nn.ReLU()
    bs = _batches(tp, tm)
    acts = cs.ActPieces(tm)
    acts.mode = "record"
    _, want = cs.tf_first_grads(tp, copy.deepcopy(tm), bs, NARROW["vocab"])
    assert len(acts.sides) == 4 * len(bs)
    acts.mode = "replay"
    acts.restart()
    _, same = cs.tf_first_grads(tp, copy.deepcopy(tm), bs, NARROW["vocab"])
    assert acts.take()["flips"] == 0
    for n in want:
        np.testing.assert_allclose(_np(same[n]), _np(want[n]), atol=1e-7)
    acts.sides = {k: ~v for k, v in acts.sides.items()}
    acts.restart()
    _, other = cs.tf_first_grads(tp, copy.deepcopy(tm), bs, NARROW["vocab"])
    assert acts.take()["flips"] == sum(int(v.numel())
                                       for v in acts.sides.values())
    assert max(float((other[n] - want[n]).abs().max()) for n in want) > 1e-3
    acts.remove()


def test_generate_square_subsequent_mask_is_the_reference_s():
    jm, tm = _pair()
    np.testing.assert_array_equal(
        _np(tm.transformer.generate_square_subsequent_mask(5)),
        _np(jm.transformer.generate_square_subsequent_mask(5)))


def test_encoder_and_cross_attention_take_flash_and_the_decoder_s_self_attention_does_not(
        monkeypatch):
    """At lengths of 128 with attention dropout 0, the encoder's
    self-attention and the cross-attention (target 128 against source
    256) reach the flash kernels' wrapper with the ``[B, Nk]`` keep-mask;
    the decoder's causal self-attention and a one-query decode step take
    the dense composition."""
    calls = []
    real = tfa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("padding_mask")
                      is not None))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tfa, "flash_attention", spy)
    with tp.utils.unique_name.guard():
        m = cs.s2s_model(tp, dropout=0.1, **NARROW)
    b = _batches(tp, m, ((2, 256, 128),))[0]
    with tflags.flags_guard(flash_attention="always"):
        logits = m(b["src"], b["tgt_in"], b["src_mask"], b["tgt_mask"])
        assert calls == [(256, 256, True)] * 2 + [(128, 256, True)] * 2
        cs.s2s_loss(tp, logits, b["tgt_out"], NARROW["vocab"]).backward()
        calls.clear()
        cs.s2s_decode(tp, m, b["src"], b["src_mask"], beam=2,
                      max_step_num=2)
        assert calls == [(256, 256, True)] * 2
