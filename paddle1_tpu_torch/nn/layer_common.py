"""Linear, Embedding and Dropout (port of the subset of
``paddle1_tpu/nn/layer_common.py`` the serving and BERT slices run).

Weights keep Paddle's layout — ``Linear.weight`` is
``[in_features, out_features]`` and ``y = x @ W + b`` — so a state dict
crosses from the JAX package unchanged (no transposed copy).

Each layer takes the reference's arguments in the reference's positions;
the port's own (``device``, ``generator``, ``normal_std``) are
keyword-only after them. ``ParamAttr`` is not ported: a
``weight_attr``/``bias_attr`` other than None (or ``bias_attr=False``,
which drops the bias as in the reference) raises."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.errors import UnimplementedError
from . import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


def check_param_attrs(layer: str, weight_attr, bias_attr) -> bool:
    """The ported subset of Paddle's ``weight_attr``/``bias_attr``: None
    (the default parameter) or ``bias_attr`` False (no bias; True is the
    default too). Returns whether the layer has a bias; a ``ParamAttr``
    raises."""
    if weight_attr is not None or bias_attr not in (None, True, False):
        raise UnimplementedError(
            f"{layer}: ParamAttr is not ported; weight_attr must be None "
            "and bias_attr None, True or False")
    return bias_attr is not False


class Linear(nn.Module):
    """``y = x @ W + b``; W is ``[in_features, out_features]``, initialized
    Xavier-uniform (or, with ``normal_std``, from N(0, normal_std²) — the
    JAX package's ``Normal(std)`` initializer), b zeros;
    ``bias_attr=False`` drops b."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 normal_std: Optional[float] = None):
        super().__init__()
        bias = check_param_attrs("Linear", weight_attr, bias_attr)
        dev = resolve_device(device)
        w = torch.empty(in_features, out_features)
        if normal_std is None:
            limit = math.sqrt(6.0 / (in_features + out_features))
            w.uniform_(-limit, limit, generator=generator)
        else:
            w.normal_(0.0, float(normal_std), generator=generator)
        self.weight = nn.Parameter(w.to(dev))
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Lookup table ``[num_embeddings, embedding_dim]``, initialized from
    a standard normal (the JAX package's default) or, with
    ``normal_std``, from N(0, normal_std²). ``padding_idx`` (negative
    from the end) zeroes that row at construction and the output of every
    id equal to it, as the reference does; ``sparse=True`` (sparse
    gradients) is not ported and raises."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 normal_std: Optional[float] = None):
        super().__init__()
        if sparse:
            raise UnimplementedError(
                "Embedding: sparse gradients (sparse=True) are not ported")
        check_param_attrs("Embedding", weight_attr, None)
        self._padding_idx = None if padding_idx is None else \
            padding_idx if padding_idx >= 0 else num_embeddings + padding_idx
        dev = resolve_device(device)
        std = 1.0 if normal_std is None else float(normal_std)
        w = torch.empty(num_embeddings, embedding_dim).normal_(
            0.0, std, generator=generator)
        if self._padding_idx is not None:
            w[self._padding_idx] = 0.0
        self.weight = nn.Parameter(w.to(dev))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = torch.nn.functional.embedding(ids, self.weight)
        if self._padding_idx is None:
            return out
        return out * (ids != self._padding_idx).unsqueeze(-1).to(out.dtype)


class Dropout(nn.Module):
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
