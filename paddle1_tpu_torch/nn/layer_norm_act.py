"""LayerNorm (port of the ``LayerNorm`` half of
``paddle1_tpu/nn/layer_norm_act.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from . import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the last ``normalized_shape`` axes with an affine
    weight (ones) and bias (zeros); epsilon 1e-5 as in Paddle."""

    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = float(epsilon)
        dev = resolve_device(device)
        self.weight = nn.Parameter(
            torch.ones(self._normalized_shape, device=dev))
        self.bias = nn.Parameter(
            torch.zeros(self._normalized_shape, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)
