"""Functionals of the port (``paddle1_tpu.nn.functional``): every name of
the JAX package's ``activation``, ``norm``, ``loss``, ``common``,
``pooling``, ``conv`` and ``crf`` modules, and the subset of
``attention`` the ported paths run."""

from .activation import *  # noqa: F401,F403
from .attention import (attention_ref, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .crf import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
