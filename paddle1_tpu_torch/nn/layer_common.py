"""Common layers (port of ``paddle1_tpu/nn/layer_common.py``, its whole
``__all__``): Linear, Embedding, the dropouts, Flatten/Unflatten, the pads,
the upsamplers, Bilinear, the distances, the shuffles, Fold and Unfold,
each over the functional of the same name.

Weights keep Paddle's layout — ``Linear.weight`` is
``[in_features, out_features]`` and ``y = x @ W + b`` — so a state dict
crosses from the JAX package unchanged (no transposed copy).

Each layer takes the reference's arguments in the reference's positions;
the port's own (``device``, ``generator``) are keyword-only after them.
``weight_attr``/``bias_attr`` take every form the JAX layer takes: None,
a ``ParamAttr``, a name or an initializer, and ``bias_attr=False`` drops
the bias. Weights are drawn on the CPU from ``generator`` and moved to
``device`` (default ``cuda``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..core.errors import UnimplementedError
from . import functional as F
from .initializer import Normal, XavierUniform
from .layer_base import Layer

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Embedding", "Flatten", "Unflatten", "Pad1D", "Pad2D", "Pad3D",
           "ZeroPad2D", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "Bilinear", "CosineSimilarity",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Identity",
           "PairwiseDistance", "Fold", "Unfold"]


class Linear(Layer):
    """``y = x @ W + b``; W is ``[in_features, out_features]``,
    Xavier-uniform by default, b zeros."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        kw = dict(device=resolve_device(device), generator=generator)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform(), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """Lookup table ``[num_embeddings, embedding_dim]``, initialized from
    a standard normal (the JAX package's default). ``padding_idx``
    (negative from the end) zeroes that row at construction and the
    output of every id equal to it, as the reference does;
    ``sparse=True`` (sparse gradients) is not ported and raises
    (ROADMAP Queue 1 item 8, the recommender slice)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        if sparse:
            raise UnimplementedError(
                "Embedding: sparse gradients (sparse=True) are not ported "
                "(ROADMAP Queue 1 item 8)")
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = None if padding_idx is None else \
            padding_idx if padding_idx >= 0 else num_embeddings + padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0),
            device=resolve_device(device), generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                torch.Tensor.__setitem__(self.weight, self._padding_idx, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self) -> str:
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """``F.dropout`` with probability ``p`` along ``axis`` in ``mode``
    (``upscale_in_train`` or ``downscale_in_infer``), in training mode
    (masks from the device's default generator); in eval mode
    ``downscale_in_infer`` scales by ``1 - p``."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self) -> str:
        return f"p={self.p}, mode={self.mode}"


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Dropout2D(Layer):
    """``F.dropout2d``: whole channels dropped in training."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ..ops import manip_ops
        return manip_ops.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    """Axis ``axis`` split into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        from ..ops import manip_ops
        new = list(x.shape)
        new[self.axis:self.axis + 1] = list(self.shape)
        return manip_ops.reshape(x, new)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Upsample(Layer):
    """``F.interpolate`` with the layer's size or scale and mode."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``, as the JAX package's
    (``paddle1_tpu/nn/layer_common.py:218``)."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class Bilinear(Layer):
    """``out = x1 . W[o] . x2 + b``; W ``[out, in1, in2]`` Xavier-uniform
    over (in1, out), b zeros."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=XavierUniform(fan_in=in1_features,
                                              fan_out=out_features), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """``p``-norm of ``x - y + epsilon`` along the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        from ..ops import linalg_ops
        return linalg_ops.norm(x - y + self.epsilon, p=self.p, axis=-1,
                               keepdim=self.keepdim)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)
