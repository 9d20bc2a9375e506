"""Losses (port of ``cross_entropy`` with hard labels from
``paddle1_tpu/nn/functional/loss.py``)."""

from __future__ import annotations

import torch

from ...core.errors import InvalidArgumentError

__all__ = ["cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100, reduction: str = "mean"
                  ) -> torch.Tensor:
    """Softmax cross entropy against integer class labels along the last
    axis (a label tensor with a trailing singleton axis is squeezed).
    Labels equal to ``ignore_index`` contribute 0; ``mean`` divides the
    sum by the count of valid labels (at least 1), ``none`` returns the
    per-position losses, ``sum`` their sum.

    The log-softmax is taken in f32 whatever the input's dtype (a bf16
    logit tensor under ``amp_dtype`` included), and the loss is f32."""
    if reduction not in ("mean", "sum", "none"):
        raise InvalidArgumentError(f"Unknown reduction {reduction!r}")
    ax = input.dim() - 1
    y = label.long()
    if y.dim() == input.dim():
        y = y.squeeze(ax)
    logp = torch.log_softmax(input, dim=ax, dtype=torch.float32)
    valid = y != ignore_index
    idx = torch.where(valid, y, torch.zeros_like(y)).unsqueeze(ax)
    loss = -torch.gather(logp, ax, idx).squeeze(ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
