"""BERT and ERNIE (``paddle1_tpu.text.models`` subset)."""

from .bert import (BertEmbeddings, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertLMPredictionHead,
                   BertModel, BertPooler, BertPretrainingCriterion,
                   ErnieForPretraining, ErnieModel, apply_megatron_sharding,
                   bert_base, bert_large, ernie_1p5b)
