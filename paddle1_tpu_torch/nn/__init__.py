"""Neural-network layers of the serving and BERT slices
(``paddle1_tpu.nn`` subset): Linear, Embedding, Dropout, LayerNorm,
MultiHeadAttention and the transformer encoder."""

from . import functional  # noqa: F401
from .layer_common import Dropout, Embedding, Linear  # noqa: F401
from .layer_norm_act import LayerNorm  # noqa: F401
from .layer_transformer import (MultiHeadAttention,  # noqa: F401
                                TransformerEncoder, TransformerEncoderLayer)
