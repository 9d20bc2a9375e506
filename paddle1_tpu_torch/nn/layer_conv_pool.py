"""Conv2D and every pooling layer (port of ``Conv2D`` and the pooling
layers of ``paddle1_tpu/nn/layer_conv_pool.py``).

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

__all__ = ["Conv2D", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
           "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool2D"]


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


class _PoolNd(Layer):
    """A pooling layer: ``kernel_size``, ``stride`` and ``padding``, the
    other keyword arguments (``ceil_mode``, ``exclusive``,
    ``return_mask``, ``data_format``) passed to the functional as they
    are (``paddle1_tpu/nn/layer_conv_pool.py:163-174``)."""

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = kwargs

    def extra_repr(self) -> str:
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool1D(_PoolNd):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class MaxPool2D(_PoolNd):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class MaxPool3D(_PoolNd):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class AvgPool1D(_PoolNd):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class AvgPool2D(_PoolNd):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class AvgPool3D(_PoolNd):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            **self.kwargs)


class _AdaptivePoolNd(Layer):
    """An adaptive pooling layer to ``output_size``. As in the JAX
    package, the 2-D and 3-D average pools pass their keyword arguments
    (``data_format``) on; the 1-D pools and the max pools take theirs and
    pass none (``return_mask`` is not read)."""

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.kwargs = kwargs


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_avg_pool2d(x, self.output_size, **self.kwargs)


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, **self.kwargs)


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)


class MaxUnPool2D(Layer):
    """``F.max_unpool2d`` of ``(x, indices)`` with the layer's
    arguments."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.data_format = data_format
        self.output_size = output_size

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, self.kernel_size, self.stride,
                              self.padding, self.data_format,
                              self.output_size)
