"""ERNIE-1.5B (BASELINE config 4) in the port against the JAX package:
``ernie_1p5b``'s configuration, the full-width parameter names and
shapes, five ``zero_stage=2`` engine steps of a narrow ERNIE on a
one-card mesh, and ``BertForSequenceClassification``. f32 on the CPU,
weights carried across with ``state_from_jax``, inputs seeded with numpy;
1e-4 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle1_tpu as paddle
from paddle1_tpu.core.flags import flags_guard as jax_flags_guard
from paddle1_tpu.core.tensor import Tensor
from paddle1_tpu.text.models import bert as jbert
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags
from paddle1_tpu_torch.distributed import ParallelEngine, build_mesh
from paddle1_tpu_torch.optimizer import AdamW
from paddle1_tpu_torch.text import models as tmodels
from paddle1_tpu_torch.text.models import bert as tbert

ALWAYS = dict(flash_attention="always", flash_backward="always",
              fused_adam="always")
# a narrow ERNIE: hidden 64 in 2 heads of 32, depth 2, the real vocabulary
NARROW = dict(hidden_size=64, num_attention_heads=2, intermediate_size=256,
              num_hidden_layers=2, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
STEPS, LR = 5, 1e-3


def test_ernie_names_are_exported_like_the_jax_package():
    for name in ("ErnieModel", "ErnieForPretraining", "ernie_1p5b",
                 "BertForSequenceClassification"):
        assert hasattr(tmodels, name) and name in tbert.__all__
    # apply_megatron_sharding came with slice 4b(ii): every name exported
    assert set(jbert.__all__) - set(tbert.__all__) == set()
    assert tmodels.ErnieModel is tmodels.BertModel
    assert tmodels.ErnieForPretraining is tmodels.BertForPretraining


def test_ernie_1p5b_configuration_equals_the_jax_package(monkeypatch):
    monkeypatch.setattr(jbert, "ErnieModel", lambda **kw: kw)
    monkeypatch.setattr(tbert, "ErnieModel", lambda **kw: kw)
    want = jbert.ernie_1p5b()
    assert tbert.ernie_1p5b() == want == dict(
        vocab_size=40000, max_position_embeddings=2048, hidden_size=2304,
        num_hidden_layers=24, num_attention_heads=18,
        intermediate_size=9216)
    assert tbert.ernie_1p5b(num_hidden_layers=2, hidden_size=64) == \
        jbert.ernie_1p5b(num_hidden_layers=2, hidden_size=64)


def test_full_width_names_and_shapes_equal_jax_and_count_1p63b():
    paddle.seed(0)
    jm = jbert.ErnieForPretraining(jbert.ernie_1p5b(num_hidden_layers=1))
    jshapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    del jm
    tm = tbert.ErnieForPretraining(tbert.ernie_1p5b(
        num_hidden_layers=1, device="cpu",
        generator=torch.Generator().manual_seed(0)))
    tshapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert tshapes == jshapes
    # 24 layers: everything outside the encoder once, the layer 24 times
    # (the tied decoder weight counted once)
    total = sum(p.numel() for p in tm.parameters())
    layer = sum(p.numel() for p in tm.bert.encoder.layers[0].parameters())
    n24 = total + 23 * layer
    assert 1.62e9 < n24 < 1.65e9 and n24 == 1_637_101_122
    assert tm.bert.encoder.layers[0].self_attn.head_dim == 128


@pytest.fixture(scope="module")
def narrow_pair():
    paddle.seed(0)
    jm = jbert.ErnieForPretraining(jbert.ernie_1p5b(**NARROW))
    state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    return jm, state


def _batch(seed=0, b=2, n=128, vocab=40000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, n)).astype(np.int32)
    ids[1, 100:] = 0                      # one padded tail
    mlm = rng.integers(0, vocab, (b, n)).astype(np.int32)
    mlm[ids == 0] = -1
    return {"ids": ids, "mlm": mlm,
            "nsp": rng.integers(0, 2, (b,)).astype(np.int32)}


def test_narrow_ernie_zero2_engine_matches_jax(narrow_pair):
    from paddle1_tpu.distributed import ParallelEngine as JEngine
    from paddle1_tpu.distributed import build_mesh as jbuild_mesh
    jm, state = narrow_pair
    jcrit = jbert.BertPretrainingCriterion(40000)
    tm = tbert.ErnieForPretraining(tbert.ernie_1p5b(device="cpu", **NARROW))
    tm.load_state_dict(state_from_jax(state, tm))
    tcrit = tbert.BertPretrainingCriterion(40000)

    def jloss(m, b):
        s, r = m(Tensor(b["ids"]))
        return jcrit(s, r, Tensor(b["mlm"]), Tensor(b["nsp"]))

    def tloss(m, b):
        s, r = m(b["ids"])
        return tcrit(s, r, b["mlm"], b["nsp"])
    batches = [_batch(seed=i % 2) for i in range(STEPS)]
    with jax_flags_guard(**ALWAYS):
        jeng = JEngine(jm, paddle.optimizer.AdamW(
            learning_rate=LR, parameters=jm.parameters()), jloss,
            mesh=jbuild_mesh(dp=1, sharding=1, devices=[jax.devices()[0]]),
            zero_stage=2)
        jl = [float(jeng.step(b)) for b in batches]
    teng = ParallelEngine(tm, AdamW(learning_rate=LR,
                                    parameters=tm.parameters()), tloss,
                          mesh=build_mesh(dp=1, sharding=1), zero_stage=2)
    with tflags.flags_guard(fused_layer_norm="always", **ALWAYS):
        tl = [float(teng.step(b)) for b in batches]
    assert teng._flat is not None and teng.zero_stage == 2
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]
    jparams = {k: np.asarray(v) for k, v in jeng.params.items()}
    checked = 0
    for name, p in tm.state_dict().items():
        if name not in jparams:
            continue              # the tied alias
        # the key bias's gradient is rounding noise (see test_torch_train)
        atol = STEPS * LR if name.endswith("k_proj.bias") else 1e-4
        np.testing.assert_allclose(p.numpy(), jparams[name], atol=atol,
                                   rtol=0, err_msg=name)
        checked += 1
    assert checked == len(jparams)


@pytest.mark.parametrize("train", [False, True])
def test_sequence_classification_logits_match_jax(narrow_pair, train):
    jm, state = narrow_pair
    paddle.seed(1)
    jc = jbert.BertForSequenceClassification(jm.bert, num_classes=3,
                                             dropout=0.0)
    tc = tbert.BertForSequenceClassification(
        tbert.ernie_1p5b(device="cpu", **NARROW), num_classes=3,
        dropout=0.0)
    js = {k: np.asarray(v) for k, v in jc.functional_state().items()}
    tc.load_state_dict(state_from_jax(js, tc))
    if not train:
        jc.eval()
        tc.eval()
    b = _batch(seed=3)
    with paddle.no_grad():
        jlog = jc(Tensor(jnp.asarray(b["ids"])))
    with torch.no_grad():
        tlog = tc(torch.from_numpy(b["ids"]))
    assert tuple(tlog.shape) == (2, 3)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog.numpy()),
                               atol=1e-4, rtol=0)
    assert tc.classifier.weight.shape == (64, 3)
