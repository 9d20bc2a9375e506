"""Neural-network layers of the serving, BERT, conv-net, eager LeNet and
YOLOv3 slices (``paddle1_tpu.nn`` subset): the ``Layer`` base class and
its containers (``Sequential``, ``LayerList``, ``LayerDict``,
``ParameterList``), the initializers (``nn.initializer``), Linear,
Embedding, Dropout,
LayerNorm, MultiHeadAttention and the transformer encoder; Conv2D,
MaxPool2D, AdaptiveAvgPool2D, BatchNorm/BatchNorm2D, SyncBatchNorm,
ReLU, LeakyReLU, Softmax and LogSoftmax; and the gradient
clips (``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``,
``clip_grad_norm_``, ``clip_grad_value_``)."""

from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer_base import (HookRemoveHelper, Layer, LayerDict,  # noqa: F401
                         LayerList, ParameterList, Sequential)
from .layer_common import Dropout, Embedding, Linear  # noqa: F401
from .layer_conv_pool import (AdaptiveAvgPool2D, Conv2D,  # noqa: F401
                              MaxPool2D)
from .layer_norm_act import (BatchNorm, BatchNorm2D, LayerNorm,  # noqa: F401
                             LeakyReLU, LogSoftmax, ReLU, Softmax,
                             SyncBatchNorm)
from .layer_transformer import (MultiHeadAttention,  # noqa: F401
                                TransformerEncoder, TransformerEncoderLayer)
