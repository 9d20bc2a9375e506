"""Optimizers and LR schedulers of the port (``paddle1_tpu.optimizer``
subset)."""

from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Momentum, Optimizer  # noqa: F401
