"""Functionals of the serving and BERT slices (``paddle1_tpu.nn.functional``
subset)."""

from .activation import gelu, relu, tanh  # noqa: F401
from .attention import (attention_ref, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import dropout  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import layer_norm  # noqa: F401
