"""BERT pretraining model (port of ``paddle1_tpu/text/models/bert.py``).

Same modules, attribute names and constructor arguments as the JAX
package, so ``convert.state_from_jax`` carries a ``functional_state()``
across name for name, and every model is an ``nn.Layer`` whose
parameters carry the JAX package's names. The embeddings are built
through ``ParamAttr(initializer=Normal(std=initializer_range))`` as in
``paddle1_tpu/text/models/bert.py:44-54``. Attention goes through
``F.scaled_dot_product_attention``: the default attention mask is the
boolean ``ids != pad_token_id`` as ``[B, 1, 1, N]``, which the routing
proves to be a padding mask and hands to the flash kernels.

The MLM decoder is tied: ``cls.decoder_weight`` IS
``bert.embeddings.word_embeddings.weight`` (one ``Parameter``), so
``named_parameters()`` lists it once and autograd sums both gradient
paths into one gradient — one update, as the JAX engine's dedupe gives.
``state_dict()`` lists both names, as ``functional_state()`` does.

ERNIE is the same encoder (``ErnieModel``/``ErnieForPretraining`` are
aliases, as in the JAX package); ``ernie_1p5b`` pins BASELINE config 4's
sizes: hidden 2304, 24 layers of 18 heads of 128, FFN 9216, vocabulary
40000, 2048 positions, ≈ 1.64 B parameters. Only the embeddings, one
encoder layer and the heads are drawn from ``generator`` (≈ 0.2 B values
on the CPU): the other layers are copies of the first, made on the
device, as Paddle's ``TransformerEncoder`` builds them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.device import resolve_device
from ...distributed.collective import _c_concat, _c_identity
from ...framework.param_attr import ParamAttr
from ...nn import functional as F
from ...ops import math_ops
from ...nn.initializer import Normal
from ...nn.layer_base import Layer
from ...nn.layer_common import Dropout, Embedding, Linear
from ...nn.layer_norm_act import LayerNorm
from ...nn.layer_transformer import (TransformerEncoder,
                                     TransformerEncoderLayer)

__all__ = ["BertEmbeddings", "BertPooler", "BertModel",
           "BertLMPredictionHead", "BertForPretraining",
           "BertPretrainingCriterion", "BertForSequenceClassification",
           "ErnieModel", "ErnieForPretraining", "bert_base", "bert_large",
           "ernie_1p5b", "apply_megatron_sharding"]


class BertEmbeddings(Layer):
    """word + position + token_type embeddings → LayerNorm → dropout."""

    def __init__(self, vocab_size, hidden_size, hidden_dropout_prob,
                 max_position_embeddings, type_vocab_size,
                 initializer_range=0.02, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        attr = ParamAttr(initializer=Normal(std=initializer_range))
        kw = dict(weight_attr=attr, device=device, generator=generator)
        self.word_embeddings = Embedding(vocab_size, hidden_size, **kw)
        self.position_embeddings = Embedding(max_position_embeddings,
                                             hidden_size, **kw)
        self.token_type_embeddings = Embedding(type_vocab_size, hidden_size,
                                               **kw)
        self.layer_norm = LayerNorm(hidden_size, device=device)
        self.dropout = Dropout(hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq_len = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq_len, dtype=torch.int32,
                                        device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids) +
               self.position_embeddings(position_ids) +
               self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, hidden_size, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, device=device,
                            generator=generator)

    def forward(self, hidden_states):
        return F.tanh(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    """BERT encoder (the paddlenlp constructor signature). Weights are
    drawn on the CPU from ``generator`` and moved to ``device`` (default
    ``cuda``)."""

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, pad_token_id=0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.pad_token_id = pad_token_id
        self.initializer_range = initializer_range
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, hidden_dropout_prob,
            max_position_embeddings, type_vocab_size, initializer_range,
            device=dev, generator=generator)
        encoder_layer = TransformerEncoderLayer(
            hidden_size, num_attention_heads, intermediate_size,
            dropout=hidden_dropout_prob, activation=hidden_act,
            attn_dropout=attention_probs_dropout_prob, act_dropout=0.0,
            device=dev, generator=generator)
        self.encoder = TransformerEncoder(encoder_layer, num_hidden_layers)
        self.pooler = BertPooler(hidden_size, device=dev,
                                 generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is None:
            # boolean keep-mask: provably padding-shaped, so attention
            # stays on the flash kernels
            attention_mask = (input_ids != self.pad_token_id)[:, None,
                                                              None, :]
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        encoded = self.encoder(emb, attention_mask)
        pooled = self.pooler(encoded)
        return encoded, pooled


class BertLMPredictionHead(Layer):
    """MLM head: transform + activation + LayerNorm + a decoder tied to
    the word embeddings (``[vocab, hidden]``, used transposed)."""

    def __init__(self, hidden_size, vocab_size, activation="gelu",
                 embedding_weights: Optional[torch.nn.Parameter] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.transform = Linear(hidden_size, hidden_size, device=dev,
                                generator=generator)
        self.activation = getattr(F, activation)
        self.layer_norm = LayerNorm(hidden_size, device=dev)
        self.decoder_weight = embedding_weights
        self.decoder_bias = self.create_parameter([vocab_size], is_bias=True,
                                                  device=dev)

    def forward(self, hidden_states, masked_positions=None, *,
                mp_group=None):
        """``mp_group``: the model-parallel group when the tied decoder is
        this rank's vocabulary shard (``distributed.meta_parallel.
        shard_tagged_layers`` binds it): Megatron's f before the decoder,
        this rank's logit columns gathered over the group, then the whole
        bias."""
        if masked_positions is not None:
            # gather the masked token positions: [B, S, H] → [M, H]
            b, s, h = hidden_states.shape
            hidden_states = hidden_states.reshape(b * s, h)[
                masked_positions.reshape(-1).long()]
        x = self.layer_norm(self.activation(self.transform(hidden_states)))
        if mp_group is not None:
            x = _c_identity(x, mp_group)
        logits = math_ops.matmul(x, self.decoder_weight, transpose_y=True)
        if mp_group is not None:
            logits = _c_concat(logits, mp_group)
        return logits + self.decoder_bias


class BertForPretraining(Layer):
    """MLM + NSP pretraining heads over BertModel."""

    def __init__(self, bert: BertModel,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert = bert
        dev = bert.embeddings.word_embeddings.weight.device
        self.cls = BertLMPredictionHead(
            bert.hidden_size, bert.vocab_size,
            embedding_weights=bert.embeddings.word_embeddings.weight,
            device=dev, generator=generator)
        self.seq_relationship = Linear(bert.hidden_size, 2, device=dev,
                                       generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_positions=None):
        encoded, pooled = self.bert(input_ids, token_type_ids, position_ids,
                                    attention_mask)
        prediction_scores = self.cls(encoded, masked_positions)
        seq_relationship_score = self.seq_relationship(pooled)
        return prediction_scores, seq_relationship_score


class BertPretrainingCriterion(Layer):
    """MLM + NSP loss: the MLM cross entropy (ignore_index -1) per
    position divided by ``masked_lm_scale`` and averaged over every
    position, plus the mean NSP cross entropy."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels,
                masked_lm_scale=1.0):
        mlm = F.cross_entropy(prediction_scores, masked_lm_labels,
                              reduction="none", ignore_index=-1)
        mlm = (mlm / float(masked_lm_scale)).mean()
        nsp = F.cross_entropy(seq_relationship_score, next_sentence_labels,
                              reduction="mean")
        return mlm + nsp


class BertForSequenceClassification(Layer):
    """Dropout and a linear classifier over the pooled output."""

    def __init__(self, bert: BertModel, num_classes=2, dropout=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert = bert
        self.dropout = Dropout(dropout if dropout is not None else 0.1)
        self.classifier = Linear(
            bert.hidden_size, num_classes,
            device=bert.embeddings.word_embeddings.weight.device,
            generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


# ERNIE shares the BERT architecture at this scale (the JAX package's
# aliases)
ErnieModel = BertModel
ErnieForPretraining = BertForPretraining


def bert_base(**kw) -> BertModel:
    return BertModel(hidden_size=768, num_hidden_layers=12,
                     num_attention_heads=12, intermediate_size=3072, **kw)


def bert_large(**kw) -> BertModel:
    return BertModel(hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096, **kw)


def ernie_1p5b(**kw) -> BertModel:
    """ERNIE 1.5B-class encoder (BASELINE config 4): hidden 2304, 24
    layers of 18 heads, FFN 9216, vocabulary 40000, 2048 positions; any
    of them can be overridden by keyword."""
    kw.setdefault("vocab_size", 40000)
    kw.setdefault("max_position_embeddings", 2048)
    kw.setdefault("hidden_size", 2304)
    kw.setdefault("num_hidden_layers", 24)
    kw.setdefault("num_attention_heads", 18)
    kw.setdefault("intermediate_size", 9216)
    return ErnieModel(**kw)


def apply_megatron_sharding(model: Layer, mp_axis: str = "mp") -> Layer:
    """Tag the transformer's parameters with Megatron's tensor-parallel
    axes (``sharding_axes``, the JAX package's ``bert.py:242-264``):
    column-parallel (the output dimension, biases too) for the q/k/v
    projections and the FFN's up-projection, row-parallel (the input
    dimension; the bias stays whole) for the attention output and the
    FFN's down-projection, and the vocabulary for the word embedding and
    the MLM decoder tied to it. Metadata only: ``ParallelEngine`` on a
    mesh with ``mp > 1`` cuts each tagged tensor to its rank's shard and
    runs the layers with the Megatron pairs
    (``distributed.meta_parallel.shard_tagged_layers``)."""
    for name, p in model.named_parameters():
        axes = [None] * p.dim()
        if "word_embeddings" in name and p.dim() == 2:
            axes[0] = mp_axis
        elif any(k in name for k in ("q_proj", "k_proj", "v_proj",
                                     "linear1")):
            axes[-1] = mp_axis          # [in, out] → shard out
        elif any(k in name for k in ("out_proj", "linear2")):
            if p.dim() == 2:
                axes[0] = mp_axis       # [in, out] → shard in
        p.sharding_axes = tuple(axes) if any(a is not None
                                             for a in axes) else None
    return model
