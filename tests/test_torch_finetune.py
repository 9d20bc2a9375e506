"""BERT fine-tuning in eager dygraph (the port's eighth main path, at a
narrow size) against the JAX package's eager loop.

A seeded ``BertForPretraining`` is saved with ``save(model.state_dict())``
and warm-starts a ``BertForSequenceClassification`` through
``set_state_dict(load(path))`` in each package; the classifier head is a
``Linear`` whose weight has ``ParamAttr(learning_rate=0.5)`` and whose
bias has an ``L2Decay`` regularizer. Then three eager steps of
``AdamW(LinearWarmup(PolynomialDecay(...)))`` with PaddleNLP's decay
filter (``decay_params``: the names of every parameter outside biases and
norms), each ``loss.backward(); opt.step(); sched.step();
opt.clear_grad()``, on a batch with ragged padding.

Held to the JAX package: the warm start's ``(missing, unexpected)``
exactly; the losses and every parameter within 1e-4 (f32 sums in another
order over three steps), the attention key biases within 3 x lr (their
gradient is 0 in exact arithmetic, so Adam moves them by rounding noise
over eps in each package independently, as ``test_torch_train.py``
holds them).
"""

import numpy as np
import pytest
import torch

import paddle1_tpu as jp
import paddle1_tpu_torch as tp
from paddle1_tpu.core.tensor import to_tensor
from paddle1_tpu_torch.convert import state_from_jax
from paddle1_tpu_torch.core import flags as tflags

CFG = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=64,
           max_position_embeddings=64, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
B, S, STEPS, LR, HEAD_LR, L2 = 4, 16, 3, 1e-3, 0.5, 0.01
TOL = dict(atol=1e-4, rtol=0)


def _state(layer):
    return {k: np.asarray(v) for k, v in layer.functional_state().items()}


@pytest.fixture
def fresh_names():
    from paddle1_tpu.nn import layer_base as jlb
    from paddle1_tpu_torch.nn import layer_base as tlb
    saved = [dict(m._global_layer_name_counts) for m in (jlb, tlb)]
    for m in (jlb, tlb):
        m._global_layer_name_counts.clear()
    yield
    for m, old in zip((jlb, tlb), saved):
        m._global_layer_name_counts.clear()
        m._global_layer_name_counts.update(old)


def _batch():
    rng = np.random.default_rng(3)
    ids = rng.integers(1, CFG["vocab_size"], (B, S)).astype(np.int32)
    for row, n in enumerate((S, 11, 6, 14)):    # ragged padding
        ids[row, n:] = 0
    labels = (ids[:, 1] % 2).astype(np.int32)   # learnable from a token
    return ids, labels


def _classifier(m, bert, kw):
    clf = m.text.models.BertForSequenceClassification(bert, num_classes=2,
                                                      dropout=0.0)
    clf.classifier = m.nn.Linear(
        CFG["hidden_size"], 2, weight_attr=m.ParamAttr(learning_rate=HEAD_LR),
        bias_attr=m.ParamAttr(regularizer=m.regularizer.L2Decay(L2)), **kw)
    return clf


def _finetune(m, clf, ids, labels, place):
    decay_params = [p.name for n, p in clf.named_parameters()
                    if not any(nd in n for nd in ["bias", "norm"])]
    sched = m.optimizer.lr.LinearWarmup(
        m.optimizer.lr.PolynomialDecay(LR, decay_steps=10), warmup_steps=2,
        start_lr=0.0, end_lr=LR)
    opt = m.optimizer.AdamW(learning_rate=sched,
                            parameters=clf.parameters(), weight_decay=0.01,
                            apply_decay_param_fun=lambda x: x in
                            decay_params)
    losses = []
    for _ in range(STEPS):
        if m is jp:
            x, y = to_tensor(ids), to_tensor(labels)
        else:
            x = tp.to_tensor(ids.astype(np.int64), place=place)
            y = tp.to_tensor(labels.astype(np.int64), place=place)
        loss = m.nn.functional.cross_entropy(clf(x), y)
        loss.backward()
        opt.step()
        sched.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return losses, decay_params


@pytest.fixture
def warm(fresh_names, tmp_path):
    jp.seed(0)
    jpre = jp.text.models.BertForPretraining(
        jp.text.models.BertModel(**CFG))
    tpre = tp.text.models.BertForPretraining(
        tp.text.models.BertModel(device="cpu", **CFG))
    tpre.load_state_dict(state_from_jax(_state(jpre), tpre))
    jpath, tpath = str(tmp_path / "jax.pdparams"), \
        str(tmp_path / "torch.pdparams")
    jp.save(jpre.state_dict(), jpath)
    tp.save(tpre.state_dict(), tpath)
    jclf = _classifier(jp, jp.text.models.BertModel(**CFG), {})
    tclf = _classifier(tp, tp.text.models.BertModel(device="cpu", **CFG),
                       dict(device="cpu"))
    jret = jclf.set_state_dict(jp.load(jpath))
    with tp.device_guard("cpu"):
        tret = tclf.set_state_dict(tp.load(tpath))
    # the fresh head: the reference's values carried across
    tclf.classifier.load_state_dict(
        state_from_jax(_state(jclf.classifier), tclf.classifier))
    return jclf, tclf, tpre, jret, tret


def test_warm_start_missing_and_unexpected_are_the_references(warm):
    jclf, tclf, tpre, jret, tret = warm
    assert tuple(tret) == tuple(jret)
    missing, unexpected = tret
    assert missing == ["classifier.weight", "classifier.bias"]
    assert sorted(unexpected) == sorted(
        k for k in tpre.state_dict() if not k.startswith("bert."))
    for k, v in tpre.bert.state_dict().items():
        assert torch.equal(tclf.bert.state_dict()[k], v), k
    assert tclf.classifier.weight.optimize_attr == {"learning_rate": HEAD_LR}
    assert tclf.classifier.bias.regularizer.coeff == L2


@pytest.mark.parametrize("fused_adam", ["always", "never"])
def test_three_eager_adamw_steps_match_the_jax_loop(warm, fused_adam):
    jclf, tclf, _, _, _ = warm
    ids, labels = _batch()
    with tflags.flags_guard(fused_adam=fused_adam, flash_attention="always",
                            flash_backward="always",
                            fused_layer_norm="always"):
        tl, tdecay = _finetune(tp, tclf, ids, labels, "cpu")
    jl, jdecay = _finetune(jp, jclf, ids, labels, None)
    # the classifier's BERT is built after the pretraining one: its
    # embeddings are the fourth to sixth, its first Linear the tenth
    assert tdecay == jdecay and tdecay[0] == "embedding_3.weight" and \
        "linear_9.weight" in tdecay
    assert not any(n.endswith(".bias") or "layernorm" in n for n in tdecay)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    tstate = tclf.state_dict()
    for k, v in _state(jclf).items():
        got = tstate[k].numpy()
        if k.endswith("k_proj.bias"):
            np.testing.assert_allclose(got, v, atol=3 * LR, rtol=0)
        else:
            np.testing.assert_allclose(got, v, err_msg=k, **TOL)


def test_the_filter_and_the_head_rate_take_effect(warm):
    """One step against the same step without decay: parameters the
    filter excludes (biases, norms) are equal to it bit for bit, the
    others differ."""
    _, tclf, _, _, _ = warm
    ids, labels = _batch()
    twin = tp.text.models.BertForSequenceClassification(
        tp.text.models.BertModel(device="cpu", **CFG), num_classes=2,
        dropout=0.0)
    twin.classifier = tp.nn.Linear(
        CFG["hidden_size"], 2, device="cpu",
        weight_attr=tp.ParamAttr(learning_rate=HEAD_LR),
        bias_attr=tp.ParamAttr(regularizer=tp.regularizer.L2Decay(L2)))
    twin.set_state_dict(tclf.state_dict())
    names = {id(p): n for n, p in tclf.named_parameters()}
    decay = [p.name for n, p in tclf.named_parameters()
             if not any(nd in n for nd in ["bias", "norm"])]
    runs = []
    for model, wd in ((tclf, 0.01), (twin, 0.0)):
        opt = tp.optimizer.AdamW(
            learning_rate=LR, parameters=model.parameters(),
            weight_decay=wd, apply_decay_param_fun=lambda x: x in decay)
        x = tp.to_tensor(ids.astype(np.int64), place="cpu")
        y = tp.to_tensor(labels.astype(np.int64), place="cpu")
        tp.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
        runs.append([p.detach().clone() for p in model.parameters()])
    for p, a, b in zip(tclf.parameters(), *runs):
        if p.name in decay:
            assert not torch.equal(a, b), names[id(p)]
        else:
            assert torch.equal(a, b), names[id(p)]
