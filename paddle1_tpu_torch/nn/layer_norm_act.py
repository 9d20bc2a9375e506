"""LayerNorm, batch norm, ReLU and Sequential (port of the subset of
``paddle1_tpu/nn/layer_norm_act.py`` the serving, BERT and conv-net
slices run)."""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.errors import UnimplementedError
from . import functional as F

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm2D", "ReLU", "Sequential"]


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


class _BatchNormBase(nn.Module):
    """Batch norm over the channel axis with Paddle's running statistics:
    f32 buffers ``_mean`` (zeros) and ``_variance`` (ones), blended as
    ``m * old + (1 - m) * batch`` with the biased batch variance. The
    affine ``weight`` is ones and ``bias`` zeros; ``weight_attr`` /
    ``bias_attr`` ``False`` drop them. ``use_global_stats`` is read on
    every call: True normalizes with the running statistics even in
    training mode (frozen statistics), None follows ``self.training``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-05, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 device=None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None,
                                                                 False):
            raise UnimplementedError(
                "batch norm: only weight_attr/bias_attr None or False are "
                "ported")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        self.weight = None if weight_attr is False else nn.Parameter(
            torch.ones(num_features, device=dev))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros(num_features, device=dev))
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """Legacy fluid-style BatchNorm (any rank)."""


class BatchNorm2D(_BatchNormBase):
    pass


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class Sequential(nn.Sequential):
    """Layers called in order, named ``"0"``, ``"1"``, ... or by the
    names of an ``OrderedDict`` or of ``(name, layer)`` pairs."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
            return
        if layers and all(isinstance(l, tuple) for l in layers):
            super().__init__(OrderedDict(layers))
            return
        super().__init__(*layers)
