"""Functionals of the serving, BERT, conv-net, eager LeNet and YOLOv3
slices (``paddle1_tpu.nn.functional`` subset)."""

from .activation import (gelu, leaky_relu, log_softmax,  # noqa: F401
                         relu, softmax, softmax_, tanh)
from .attention import (attention_ref, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import dropout, interpolate, linear, upsample  # noqa: F401
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import batch_norm, fused_batch_norm_act, layer_norm  # noqa: F401
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401
