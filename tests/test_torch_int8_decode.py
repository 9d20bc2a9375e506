"""int8 decode weights of the PyTorch port against the JAX package, on
the CPU (mirrors ``tests/test_generate_paged.py::TestInt8Decode``).

Held: the per-channel int8 codes equal the JAX package's exactly and the
scales within 1e-7 relative (both divide the same f32 abs-max by 127; the
codes round the same quotient half to even); the same weights are
quantized and skipped; greedy tokens of the int8 engines (dense, paged,
paged + speculation) equal the JAX package's int8 engines'; and the
engine's logits equal a plain forward of the model on the dequantized
weights to 1e-5 (the same f32 arithmetic, another order of the cast).
Small size: vocab 32, ``d_model`` 32, 2 heads, 2 layers, float32.
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.quantization import QuantTensor as JQuantTensor
from paddle1_tpu.quantization import dequantize_weights as j_dequantize
from paddle1_tpu.quantization import quantize_weights_int8 as j_quantize
from paddle1_tpu.serving import CausalLM as JCausalLM
from paddle1_tpu.serving import GenerationEngine as JEngine
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.quantization import (QuantTensor, dequantize_weights,
                                            quantize_weights_int8)
from paddle1_tpu_torch.serving import (CausalLM, GenerationEngine,
                                       GenerationServer)

VOCAB, MAX_SEQ, PS = 32, 64, 8
PROMPT = np.array([3, 1, 4, 1, 5], np.int32)


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


def _run(eng, prompt, steps, slot=0):
    out = [eng.prefill(slot, np.asarray(prompt, np.int32), 0.0, 0, 1)]
    active = np.zeros([eng.slots], bool)
    active[slot] = True
    while len(out) < steps + 1:
        toks, flags = eng.decode(active)
        out += [int(t) for t in np.asarray(toks)[slot][np.asarray(
            flags)[slot]]]
    eng.release(slot)
    return out[:steps + 1]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shape", [(32, 16), (7, 33), (512, 128)])
def test_int8_codes_and_scales_match_jax(seed, shape):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 10 ** rng.uniform(-3, 1)).astype(
        np.float32)
    w[:, 0] = 0.0            # an all-zero channel takes the 1e-8 floor
    name = "layers.0.fc.weight"
    got = quantize_weights_int8({name: torch.from_numpy(w)})[name]
    want = j_quantize({name: w})[name]
    assert isinstance(got, QuantTensor) and isinstance(want, JQuantTensor)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-7, atol=0)
    deq = dequantize_weights({name: got})[name]
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(j_dequantize({name: want})[name]),
        rtol=1e-7, atol=0)
    # per-channel rounding bound: half a quantization step
    assert (np.abs(deq.numpy() - w) <= 0.5 * got.scale.numpy()[None]
            + 1e-7).all()


def test_the_same_weights_are_quantized_as_in_jax(lm_pair):
    jl, tl = lm_pair
    want = j_quantize(jl.functional_state())
    got = quantize_weights_int8(
        {k: v.detach() for k, v in tl.state_dict().items()})
    assert sorted(got) == sorted(want)
    for k in got:
        assert isinstance(got[k], QuantTensor) == \
            isinstance(want[k], JQuantTensor), k
        if isinstance(got[k], QuantTensor):
            np.testing.assert_array_equal(got[k].q.numpy(),
                                          np.asarray(want[k].q))
    assert not isinstance(got["embed.weight"], QuantTensor)
    assert not isinstance(got["pos_embed.weight"], QuantTensor)
    assert isinstance(got["head.weight"], QuantTensor)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(paged=True, page_size=PS),
    dict(paged=True, page_size=PS, spec_tokens=2),
], ids=["dense", "paged", "paged_spec"])
def test_int8_engine_greedy_matches_jax(lm_pair, kw):
    jl, tl = lm_pair
    common = dict(slots=2, max_seq=MAX_SEQ, prefill_buckets=(8, 16),
                  int8=True, **kw)
    prompt = np.array([1, 2, 3, 4] * 3, np.int32)
    want = _run(JEngine(jl, **common), prompt, 10)
    got = _run(GenerationEngine(tl, **common), prompt, 10)
    assert got == want


def test_int8_logits_equal_a_forward_on_the_dequantized_weights(lm_pair):
    _, tl = lm_pair
    eng = GenerationEngine(tl, slots=2, max_seq=MAX_SEQ,
                           prefill_buckets=(8,), int8=True)
    toks = _run(eng, PROMPT, 3)
    deq = dequantize_weights(eng._params)
    seq = torch.tensor([list(PROMPT) + toks[:-1]])
    with torch.inference_mode():
        ref = torch.func.functional_call(tl, deq, (seq,))[0]
        f32 = tl(seq)[0]
    eng.prefill(0, PROMPT, 0.0, 0, 1)
    np.testing.assert_allclose(eng.last_prefill_logits.numpy(),
                               ref[len(PROMPT) - 1].numpy(), atol=1e-5,
                               rtol=0)
    eng.release(0)
    # the quantization itself moved the logits (int8 is lossy)
    assert float((ref - f32).abs().max()) > 1e-4
    # the model's own weights stay f32 and untouched
    assert tl.head.weight.dtype == torch.float32


def test_int8_quarters_the_weight_bytes(lm_pair):
    eng = GenerationEngine(lm_pair[1], slots=2, max_seq=MAX_SEQ,
                           prefill_buckets=(8,), int8=True)
    quant = [v for v in eng._params.values() if isinstance(v, QuantTensor)]
    assert quant, "no decode matmul weight was quantized"
    q_bytes = sum(v.q.numel() + v.scale.numel() * 4 for v in quant)
    f_bytes = sum(v.q.numel() * 4 for v in quant)
    assert q_bytes < 0.3 * f_bytes


def test_int8_flag_and_server(lm_pair):
    from paddle1_tpu_torch.core.flags import flags_guard
    with flags_guard(serve_gen_int8=True):
        eng = GenerationEngine(lm_pair[1], slots=2, max_seq=MAX_SEQ,
                               prefill_buckets=(8,))
    assert eng.int8
    srv = GenerationServer(eng, token_budget=8).start()
    got = srv.generate(list(PROMPT), max_new_tokens=8)
    rep = srv.drain()
    assert got == _run(eng, PROMPT, 7)
    assert rep["unaccounted"] == 0 and rep["tokens_owed"] == 0
