"""Activation functionals (port of the subset of
``paddle1_tpu/nn/functional/activation.py`` the serving slice runs)."""

from __future__ import annotations

import torch

__all__ = ["relu"]


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)
