"""Normalization and activation layers (port of
``paddle1_tpu/nn/layer_norm_act.py``, its whole ``__all__``), and the
containers ``Sequential``, ``LayerList``, ``LayerDict`` and
``ParameterList`` (``nn/layer_base.py``).

Every layer with parameters takes ``device`` (default: the current place)
and ``generator`` (for seeded draws) after the reference's arguments,
keyword-only; its parameters and buffers keep the JAX package's names and
shapes, so a state dict crosses unchanged (``convert.state_from_jax``).
"""

from __future__ import annotations

import inspect
import math
from typing import Optional

import torch

from ..amp import cast_point
from ..core.device import resolve_device
from . import functional as F
from .initializer import Constant, Normal
from .layer_base import (Layer, LayerDict, LayerList,  # noqa: F401
                         ParameterList, Sequential)

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
    "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm", "RMSNorm",
    "ReLU", "ReLU6", "LeakyReLU", "PReLU", "RReLU", "ELU", "SELU", "CELU",
    "GELU", "Sigmoid", "LogSigmoid", "Hardshrink", "Hardsigmoid", "Hardswish",
    "Hardtanh", "Softshrink", "Softsign", "Softplus", "Softmax", "LogSoftmax",
    "Tanh", "Tanhshrink", "ThresholdedReLU", "Silu", "Swish", "Mish", "GLU",
    "Maxout", "Sequential", "LayerList", "ParameterList", "LayerDict",
]


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
    ``bias_attr`` take every ``ParamAttr`` form, ``False`` drops them
    (both or neither: ``F.batch_norm`` raises on one alone).
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


class BatchNorm1D(_BatchNormBase):
    """Batch norm of ``[N, C]`` or ``[N, C, L]`` (channels on axis 1 under
    ``NCHW``, the default, as in the JAX package). Under ``conv_nhwc`` a
    3-D input is permuted to ``[N, L, C]`` (one copy), which gives the
    kernels their ``[rows, C]`` view."""


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    """Batch norm of ``[N, C, D, H, W]``; under ``conv_nhwc`` on
    ``torch.channels_last_3d`` memory."""


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


# ---------------------------------------------------------------------------
# the other norms


def _kw(device, generator):
    return dict(device=resolve_device(device), generator=generator)


@cast_point("rms_norm")
def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              epsilon: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)`` over the last axis in f32, cast back
    to x's dtype, times ``weight`` (the JAX package's ``rms_norm`` op)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + epsilon)).to(x.dtype) * weight


class RMSNorm(Layer):
    """Root-mean-square norm over the last axis with a weight of ones
    (no reference analog; the JAX package's, for modern LLM blocks)."""

    def __init__(self, normalized_shape, epsilon: float = 1e-6,
                 weight_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0), **_kw(device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, self.weight, self._epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
    """``F.group_norm`` with a per-channel weight (ones) and bias (zeros);
    ``weight_attr``/``bias_attr`` ``False`` drops them (both or neither:
    ``F.group_norm`` raises on one alone)."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-05, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__()
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        kw = _kw(device, generator)
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_channels], attr=weight_attr,
                                  default_initializer=Constant(1.0), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)

    def extra_repr(self) -> str:
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}")


class _InstanceNormBase(Layer):
    """``F.instance_norm`` with a per-channel weight (ones) and bias
    (zeros), both dropped by ``weight_attr=False`` (the JAX package's
    rule); ``momentum`` and ``data_format`` are taken and not read, as
    there."""

    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is not False:
            kw = _kw(device, generator)
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0), **kw)
            self.bias = self.create_parameter(
                [num_features], attr=bias_attr, is_bias=True, **kw)
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               epsilon=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    """``F.local_response_norm`` with the given window and constants."""

    def __init__(self, size: int, alpha: float = 0.0001, beta: float = 0.75,
                 k: float = 1.0, data_format: str = "NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.local_response_norm(x, *self.args)


@cast_point("spectral_norm")
def _spectral_norm(w, u, v, dim: int, iters: int, eps: float):
    """``w / sigma``, sigma from ``iters`` power iterations on ``w``
    flattened to ``[w.shape[dim], -1]`` from ``u`` and ``v`` (the JAX
    package's ``spectral_norm`` op; differentiable in ``w`` through the
    iterations)."""
    wm = torch.reshape(torch.movedim(w, dim, 0), (w.shape[dim], -1))
    for _ in range(iters):
        v = torch.matmul(wm.transpose(0, 1), u)
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = torch.matmul(wm, v)
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = torch.dot(u, torch.matmul(wm, v))
    return w / sigma


class SpectralNorm(Layer):
    """Spectral normalization of a weight tensor by power iteration
    (reference ``spectral_norm_op.cc``). ``weight_u`` ``[h]`` and
    ``weight_v`` ``[w]`` are parameters drawn from N(0, 1) with
    ``stop_gradient`` True; as in the JAX package each forward iterates
    from them and does not write them back."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 eps: float = 1e-12, name=None, dtype="float32", *,
                 device=None, generator=None):
        super().__init__(dtype=dtype)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = int(weight_shape[dim])
        w = math.prod(int(s) for s in weight_shape) // h
        kw = _kw(device, generator)
        self.weight_u = self.create_parameter(
            [h], default_initializer=Normal(0.0, 1.0), **kw)
        self.weight_u.stop_gradient = True
        self.weight_v = self.create_parameter(
            [w], default_initializer=Normal(0.0, 1.0), **kw)
        self.weight_v.stop_gradient = True

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        return _spectral_norm(weight, self.weight_u, self.weight_v,
                              self._dim, self._power_iters, self._eps)


# ---------------------------------------------------------------------------
# activation layers without parameters: the JAX package's ``_act_layer``,
# each argument in its position with its default, then ``name``


def _act_layer(cls_name: str, fn_name: str, **defaults):
    P = inspect.Parameter
    sig = inspect.Signature(
        [P("self", P.POSITIONAL_OR_KEYWORD)] +
        [P(k, P.POSITIONAL_OR_KEYWORD, default=v)
         for k, v in defaults.items()] +
        [P("name", P.POSITIONAL_OR_KEYWORD, default=None)])

    def __init__(self, *args, **kwargs):
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        Layer.__init__(self)
        self._kwargs = {k: bound.arguments[k] for k in defaults}

    __init__.__signature__ = sig

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    return type(cls_name, (Layer,), {
        "__init__": __init__, "forward": forward, "extra_repr": extra_repr,
        "__module__": __name__,
        "__doc__": f"``F.{fn_name}`` as a layer."})


ReLU6 = _act_layer("ReLU6", "relu6")
Sigmoid = _act_layer("Sigmoid", "sigmoid")
LogSigmoid = _act_layer("LogSigmoid", "log_sigmoid")
Tanh = _act_layer("Tanh", "tanh")
Tanhshrink = _act_layer("Tanhshrink", "tanhshrink")
Softsign = _act_layer("Softsign", "softsign")
Silu = _act_layer("Silu", "silu")
Swish = _act_layer("Swish", "swish")
Mish = _act_layer("Mish", "mish")
ELU = _act_layer("ELU", "elu", alpha=1.0)
CELU = _act_layer("CELU", "celu", alpha=1.0)
SELU = _act_layer("SELU", "selu",
                  scale=1.0507009873554805, alpha=1.6732632423543772)
GELU = _act_layer("GELU", "gelu", approximate=False)
Hardshrink = _act_layer("Hardshrink", "hardshrink", threshold=0.5)
Hardsigmoid = _act_layer("Hardsigmoid", "hardsigmoid")
Hardswish = _act_layer("Hardswish", "hardswish")
Hardtanh = _act_layer("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Softshrink = _act_layer("Softshrink", "softshrink", threshold=0.5)
Softplus = _act_layer("Softplus", "softplus", beta=1.0, threshold=20.0)
ThresholdedReLU = _act_layer("ThresholdedReLU", "thresholded_relu",
                             threshold=1.0)
GLU = _act_layer("GLU", "glu", axis=-1)
Maxout = _act_layer("Maxout", "maxout", groups=2, axis=1)


class RReLU(Layer):
    """``F.rrelu``: random slopes in training (from ``generator``), their
    mean in eval."""

    def __init__(self, lower: float = 1. / 8., upper: float = 1. / 3.,
                 name=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self._generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rrelu(x, self.lower, self.upper, training=self.training,
                       generator=self._generator)

    def extra_repr(self) -> str:
        return f"lower={self.lower}, upper={self.upper}"


class PReLU(Layer):
    """``F.prelu`` with a learned slope: ``num_parameters`` of them (1, or
    one per channel), initialized to ``init``."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25,
                 weight_attr=None, data_format: str = "NCHW", name=None, *,
                 device=None, generator=None):
        super().__init__()
        self._num_parameters = num_parameters
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init), **_kw(device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight, self._data_format)

    def extra_repr(self) -> str:
        return f"num_parameters={self._num_parameters}"
