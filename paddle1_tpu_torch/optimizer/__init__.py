"""Optimizers and LR schedulers of the port (``paddle1_tpu.optimizer``)."""

from . import lr  # noqa: F401
from .optimizer import (SGD, AdaDelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, Ftrl, Lamb, Lars, Momentum, Optimizer,
                        RMSProp)

# the 2.0 API spells it Adadelta (reference optimizer/adadelta.py)
Adadelta = AdaDelta
