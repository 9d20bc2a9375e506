"""Weight regularizers (port of ``paddle1_tpu/regularizer.py``):
``L1Decay``/``L2Decay``, applied by the optimizer, which adds
``regularizer(param)`` to a parameter's gradient before its update."""

import torch

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * param


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * torch.sign(param)
