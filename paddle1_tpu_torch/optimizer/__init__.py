"""Optimizers of the port (``paddle1_tpu.optimizer`` subset)."""

from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
