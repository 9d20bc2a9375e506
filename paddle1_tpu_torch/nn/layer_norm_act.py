"""LayerNorm, batch norm, SyncBatchNorm, ReLU, LeakyReLU, Softmax,
LogSoftmax and Sequential (port of the subset of
``paddle1_tpu/nn/layer_norm_act.py`` the serving, BERT, conv-net, eager
LeNet and YOLOv3 slices run)."""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.errors import UnimplementedError
from . import functional as F

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm2D", "SyncBatchNorm", "ReLU",
           "LeakyReLU", "Softmax", "LogSoftmax", "Sequential"]


class LayerNorm(nn.Module):
    """LayerNorm over the last ``normalized_shape`` axes with an affine
    weight (ones) and bias (zeros); epsilon 1e-5 as in Paddle. The
    affine-less form and ``ParamAttr`` (``weight_attr``/``bias_attr``
    other than None) are not ported and raise."""

    def __init__(self, normalized_shape, epsilon: float = 1e-05,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None):
        super().__init__()
        if weight_attr is not None or bias_attr is not None:
            raise UnimplementedError(
                "LayerNorm: weight_attr/bias_attr other than None (no "
                "affine, ParamAttr) are not ported")
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
    def convert_sync_batchnorm(cls, layer: nn.Module) -> nn.Module:
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


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class LeakyReLU(nn.Module):
    """``F.leaky_relu`` with ``negative_slope``."""

    def __init__(self, negative_slope: float = 0.01, name=None):
        super().__init__()
        self.negative_slope = float(negative_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.negative_slope)

    def extra_repr(self) -> str:
        return f"negative_slope={self.negative_slope}"


class Softmax(nn.Module):
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
