"""Neural-network layers of the port (``paddle1_tpu.nn``): the ``Layer``
base class and its containers (``Sequential``, ``LayerList``,
``LayerDict``, ``ParameterList``), the initializers (``nn.initializer``),
every layer of the JAX package's ``layer_common.py``,
``layer_norm_act.py``, ``layer_loss.py`` and ``layer_transformer.py``
(``MultiHeadAttention``, the encoder, the decoder and ``Transformer``),
the seq2seq decoding of ``decode.py`` (``BeamSearchDecoder``,
``dynamic_decode``, ...), ``ParamAttr``; the recurrent layers of
``layer_rnn.py``; every conv and pooling layer of ``layer_conv_pool.py``;
and the gradient clips (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``,
``clip_grad_value_``)."""

from . import decode, functional, initializer  # noqa: F401
from .decode import *  # noqa: F401,F403
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
from .layer_base import (HookRemoveHelper, Layer, LayerDict,  # noqa: F401
                         LayerList, ParameterList, Sequential)
from ..framework.param_attr import ParamAttr  # noqa: F401
from .layer_common import *  # noqa: F401,F403
from .layer_conv_pool import *  # noqa: F401,F403
from .layer_loss import *  # noqa: F401,F403
from .layer_norm_act import *  # noqa: F401,F403
from .layer_rnn import *  # noqa: F401,F403
from .layer_transformer import *  # noqa: F401,F403
