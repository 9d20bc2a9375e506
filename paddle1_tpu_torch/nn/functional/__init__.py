"""Functionals of the serving, BERT, conv-net and eager LeNet slices
(``paddle1_tpu.nn.functional`` subset)."""

from .activation import (gelu, log_softmax, relu, softmax,  # noqa: F401
                         softmax_, tanh)
from .attention import (attention_ref, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import dropout  # noqa: F401
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import batch_norm, fused_batch_norm_act, layer_norm  # noqa: F401
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401
