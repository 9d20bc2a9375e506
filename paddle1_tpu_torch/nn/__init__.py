"""Neural-network layers of the serving slice (``paddle1_tpu.nn``
subset): Linear, Embedding, LayerNorm, MultiHeadAttention and the
post-norm transformer encoder."""

from . import functional  # noqa: F401
from .layer_common import Embedding, Linear  # noqa: F401
from .layer_norm_act import LayerNorm  # noqa: F401
from .layer_transformer import (MultiHeadAttention,  # noqa: F401
                                TransformerEncoder, TransformerEncoderLayer)
