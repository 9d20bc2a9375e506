"""Linear, Embedding and Dropout (port of the subset of
``paddle1_tpu/nn/layer_common.py`` the serving and BERT slices run).

Weights keep Paddle's layout — ``Linear.weight`` is
``[in_features, out_features]`` and ``y = x @ W + b`` — so a state dict
crosses from the JAX package unchanged (no transposed copy)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from . import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(nn.Module):
    """``y = x @ W + b``; W is ``[in_features, out_features]``, initialized
    Xavier-uniform (or, with ``normal_std``, from N(0, normal_std²) — the
    JAX package's ``Normal(std)`` initializer), b zeros."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None,
                 normal_std: Optional[float] = None):
        super().__init__()
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
    ``normal_std``, from N(0, normal_std²)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 normal_std: Optional[float] = None):
        super().__init__()
        dev = resolve_device(device)
        std = 1.0 if normal_std is None else float(normal_std)
        w = torch.empty(num_embeddings, embedding_dim).normal_(
            0.0, std, generator=generator)
        self.weight = nn.Parameter(w.to(dev))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Paddle's ``upscale_in_train`` dropout with probability ``p``,
    active only in training mode (masks from the device's default
    generator)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, training=self.training)

    def extra_repr(self) -> str:
        return f"p={self.p}"
