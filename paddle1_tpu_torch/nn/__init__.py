"""Neural-network layers of the port (``paddle1_tpu.nn``): the ``Layer``
base class and its containers (``Sequential``, ``LayerList``,
``LayerDict``, ``ParameterList``), the initializers (``nn.initializer``),
every normalization and activation layer (``layer_norm_act.py``) and loss
layer (``layer_loss.py``) of the JAX package; Linear, Embedding, Dropout,
MultiHeadAttention and the transformer encoder; Conv2D, MaxPool2D,
AdaptiveAvgPool2D; and the gradient clips (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``,
``clip_grad_value_``)."""

from . import functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer_base import (HookRemoveHelper, Layer, LayerDict,  # noqa: F401
                         LayerList, ParameterList, Sequential)
from .layer_common import Dropout, Embedding, Linear  # noqa: F401
from .layer_conv_pool import (AdaptiveAvgPool2D, Conv2D,  # noqa: F401
                              MaxPool2D)
from .layer_loss import *  # noqa: F401,F403
from .layer_norm_act import *  # noqa: F401,F403
from .layer_transformer import (MultiHeadAttention,  # noqa: F401
                                TransformerEncoder, TransformerEncoderLayer)
