"""BERT (``paddle1_tpu.text.models`` subset)."""

from .bert import (BertEmbeddings, BertForPretraining,  # noqa: F401
                   BertLMPredictionHead, BertModel, BertPooler,
                   BertPretrainingCriterion, bert_base, bert_large)
