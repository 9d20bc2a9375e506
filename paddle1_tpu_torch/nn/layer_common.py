"""Linear, Embedding and Dropout (port of the subset of
``paddle1_tpu/nn/layer_common.py`` the serving and BERT slices run).

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

__all__ = ["Linear", "Embedding", "Dropout"]


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

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = torch.nn.functional.embedding(ids, self.weight)
        if self._padding_idx is None:
            return out
        return out * (ids != self._padding_idx).unsqueeze(-1).to(out.dtype)

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
