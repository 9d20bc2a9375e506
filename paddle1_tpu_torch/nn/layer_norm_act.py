"""LayerNorm, batch norm, SyncBatchNorm, ReLU, LeakyReLU, Softmax and
LogSoftmax (port of the subset of ``paddle1_tpu/nn/layer_norm_act.py``
the serving, BERT, conv-net, eager LeNet and YOLOv3 slices run), and the
containers ``Sequential``, ``LayerList``, ``LayerDict`` and
``ParameterList`` (``nn/layer_base.py``)."""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from . import functional as F
from .initializer import Constant
from .layer_base import (Layer, LayerDict, LayerList,  # noqa: F401
                         ParameterList, Sequential)

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm2D", "SyncBatchNorm", "ReLU",
           "LeakyReLU", "Softmax", "LogSoftmax", "Sequential", "LayerList",
           "LayerDict", "ParameterList"]


class LayerNorm(Layer):
    """LayerNorm over the last ``normalized_shape`` axes with an affine
    weight (ones) and bias (zeros); epsilon 1e-5 as in Paddle.
    ``weight_attr``/``bias_attr`` take every ``ParamAttr`` form, and
    ``False`` drops that half of the affine (``layer_norm_act.py:196-211``
    of the JAX package)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = float(epsilon)
        kw = dict(device=resolve_device(device), generator=generator)
        self.weight = None if weight_attr is False else \
            self.create_parameter(self._normalized_shape, attr=weight_attr,
                                  default_initializer=Constant(1.0), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self._normalized_shape}"


class _BatchNormBase(Layer):
    """Batch norm over the channel axis with Paddle's running statistics:
    f32 buffers ``_mean`` (zeros) and ``_variance`` (ones), blended as
    ``m * old + (1 - m) * batch`` with the biased batch variance. The
    affine ``weight`` is ones and ``bias`` zeros; ``weight_attr`` /
    ``bias_attr`` take every ``ParamAttr`` form, ``False`` drops them.
    ``use_global_stats`` is read on every call: True normalizes with the
    running statistics even in training mode (frozen statistics), None
    follows ``self.training``."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-05, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_features], attr=weight_attr,
                                  default_initializer=Constant(1.0), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True, **kw)
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


class SyncBatchNorm(_BatchNormBase):
    """Cross-rank batch norm (Paddle's ``nn.SyncBatchNorm``). In training
    mode under a ``dp`` binding (``distributed.env.spmd_axes(dp=group)``,
    opened by ``ParallelEngine`` on a mesh, or by the caller around a
    ``DataParallel`` forward) it normalizes with the statistics of the
    group's whole batch: per-rank f32 sums (the ``local_moments`` kernel
    on the card), one SUM all-reduce, the given-statistics normalize
    (``nn/functional/norm.py``). With no binding, or in eval mode, it is
    :class:`BatchNorm` (one rank's batch is the whole batch). Under a
    binding every training-mode batch norm takes the cross-rank
    statistics, as the JAX engine's batch norms do on a sharded batch;
    this class names that layer and converts to it."""

    @classmethod
    def convert_sync_batchnorm(cls, layer: torch.nn.Module
                               ) -> torch.nn.Module:
        """Replace every batch norm in ``layer`` (itself included) by a
        SyncBatchNorm sharing its weight, bias and running statistics;
        returns the converted layer."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer._data_format,
                      use_global_stats=layer._use_global_stats,
                      device=layer._mean.device)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            new.train(layer.training)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class LeakyReLU(Layer):
    """``F.leaky_relu`` with ``negative_slope``."""

    def __init__(self, negative_slope: float = 0.01, name=None):
        super().__init__()
        self.negative_slope = float(negative_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.negative_slope)

    def extra_repr(self) -> str:
        return f"negative_slope={self.negative_slope}"


class Softmax(Layer):
    """``F.softmax`` along ``axis`` (the kernel's route on the last
    axis)."""

    def __init__(self, axis: int = -1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.softmax(x, axis=self.axis)

    def extra_repr(self) -> str:
        return f"axis={self.axis}"


class LogSoftmax(Softmax):
    """``F.log_softmax`` along ``axis``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(x, axis=self.axis)
