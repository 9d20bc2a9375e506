"""Linear and Embedding (port of the subset of
``paddle1_tpu/nn/layer_common.py`` the serving slice runs).

Weights keep Paddle's layout — ``Linear.weight`` is
``[in_features, out_features]`` and ``y = x @ W + b`` — so a state dict
crosses from the JAX package unchanged (no transposed copy)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device

__all__ = ["Linear", "Embedding"]


class Linear(nn.Module):
    """``y = x @ W + b``; W is ``[in_features, out_features]``, initialized
    Xavier-uniform, b zeros (the JAX package's defaults)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features).uniform_(
            -limit, limit, generator=generator)
        self.weight = nn.Parameter(w.to(dev))
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Lookup table ``[num_embeddings, embedding_dim]``, initialized from
    a standard normal (the JAX package's default)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        w = torch.empty(num_embeddings, embedding_dim).normal_(
            0.0, 1.0, generator=generator)
        self.weight = nn.Parameter(w.to(dev))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]
