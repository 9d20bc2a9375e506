"""Activation functionals (port of the subset of
``paddle1_tpu/nn/functional/activation.py`` the serving and BERT slices
run)."""

from __future__ import annotations

import torch

__all__ = ["relu", "gelu", "tanh"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as BERT's ``hidden_act="gelu"`` runs it in the
    JAX package (``jax.nn.gelu(approximate=False)``)."""
    return torch.nn.functional.gelu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)
