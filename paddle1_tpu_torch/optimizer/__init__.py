"""Optimizers of the port (``paddle1_tpu.optimizer`` subset)."""

from .optimizer import Adam, AdamW, Momentum, Optimizer  # noqa: F401
