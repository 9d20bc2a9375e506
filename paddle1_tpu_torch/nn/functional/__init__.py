"""Functionals the serving slice runs (``paddle1_tpu.nn.functional``
subset)."""

from .activation import relu  # noqa: F401
from .attention import (attention_ref, paged_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .norm import layer_norm  # noqa: F401
