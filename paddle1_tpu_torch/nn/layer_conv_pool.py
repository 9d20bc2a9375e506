"""Conv2D, MaxPool2D and AdaptiveAvgPool2D (port of the subset of
``paddle1_tpu/nn/layer_conv_pool.py`` the conv-net slice runs).

``Conv2D.weight`` keeps Paddle's layout ``[out, in / groups, kh, kw]``
(PyTorch's too), so a state dict crosses from the JAX package unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError, UnimplementedError
from . import functional as F
from .initializer import Uniform
from .layer_base import Layer

__all__ = ["Conv2D", "MaxPool2D", "AdaptiveAvgPool2D"]


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 2


class Conv2D(Layer):
    """2-D convolution. Weight and bias are initialized from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = in/groups * kh * kw, as
    in the JAX package; ``weight_attr``/``bias_attr`` take every
    ``ParamAttr`` form and ``bias_attr=False`` drops the bias.
    ``padding_mode`` other than ``'zeros'`` is not ported and raises."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_channels % groups != 0:
            raise InvalidArgumentError(
                "in_channels must be divisible by groups")
        if padding_mode != "zeros":
            raise UnimplementedError(
                "Conv2D: only padding_mode='zeros' is ported")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        kw = dict(device=resolve_device(device), generator=generator)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr, default_initializer=Uniform(-bound, bound),
            **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}, padding={self._padding}")


class MaxPool2D(Layer):
    """2-D max pooling; keyword arguments (``ceil_mode``,
    ``data_format``) go to ``F.max_pool2d``."""

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = kwargs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)

    def extra_repr(self) -> str:
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class AdaptiveAvgPool2D(Layer):
    """Adaptive average pooling to ``output_size``; ``data_format`` goes
    to ``F.adaptive_avg_pool2d``."""

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = kwargs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_avg_pool2d(x, self.output_size, **self.kwargs)
