"""Conv and pooling layers (port of ``paddle1_tpu/nn/layer_conv_pool.py``).

A convolution's weight keeps Paddle's layout ``[out, in / groups, *k]``
and a transposed convolution's ``[in, out / groups, *k]`` (PyTorch's
too), so a state dict crosses from the JAX package unchanged.
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

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "MaxUnPool2D"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _ConvNd(Layer):
    """An ``ndim``-D convolution or, with ``transposed``, its transpose.
    Weight and bias are initialized from U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), fan_in = in/groups * prod(kernel), as in the JAX
    package (for a transposed convolution too); ``weight_attr``/
    ``bias_attr`` take every ``ParamAttr`` form and ``bias_attr=False``
    drops the bias. ``padding_mode`` other than ``'zeros'`` is not ported
    and raises."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 ndim: int, stride=1, padding=0, dilation=1, groups: int = 1,
                 padding_mode: str = "zeros", weight_attr=None,
                 bias_attr=None, data_format: str = "NCHW",
                 transposed: bool = False, output_padding=0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_channels % groups != 0:
            raise InvalidArgumentError(
                "in_channels must be divisible by groups")
        if padding_mode != "zeros":
            raise UnimplementedError(
                f"{type(self).__name__}: only padding_mode='zeros' is "
                "ported")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, ndim)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        shape = [in_channels, out_channels // groups] if transposed else \
            [out_channels, in_channels // groups]
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        bound = 1.0 / math.sqrt(fan_in)
        kw = dict(device=resolve_device(device), generator=generator)
        self.weight = self.create_parameter(
            shape + list(self._kernel_size), attr=weight_attr,
            default_initializer=Uniform(-bound, bound), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound), **kw)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}, padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, generator=generator)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, generator=generator)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding,
                         device=device, generator=generator)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._groups, self._dilation, output_size,
                                  self._data_format)


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
