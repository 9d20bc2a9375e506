"""Losses (port of ``cross_entropy`` and ``softmax_with_cross_entropy``
from ``paddle1_tpu/nn/functional/loss.py``)."""

from __future__ import annotations

import torch

from ...amp import cast_point
from ...core.errors import InvalidArgumentError

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@cast_point("cross_entropy")
def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, label_smoothing: float = 0.0,
                  name=None) -> torch.Tensor:
    """Cross entropy of ``input`` along ``axis``, the JAX package's arms:

    - ``use_softmax`` (default): ``input`` are logits and the log-softmax
      is taken in f32 whatever their dtype (a bf16 logit tensor under
      ``amp_dtype`` included); ``use_softmax=False``: ``input`` are
      probabilities, ``log(clip(input, 1e-15, 1))``.
    - Soft labels (``soft_label``, or a label of the input's dtype and
      shape): ``-sum(label * logp)``, reduced over every position.
    - Integer class labels (a trailing singleton axis is squeezed):
      ``-logp[label]``; labels equal to ``ignore_index`` contribute 0 and
      ``mean`` divides by the count of the others (at least 1). With a
      per-class ``weight`` ``[classes]``, each loss is scaled by its
      label's weight and ``mean`` divides by the sum of those weights
      (at least 1e-12), as the reference does; with soft labels the
      weight is dropped, as the JAX package drops it (``loss.py:45``).
    - ``label_smoothing`` ε mixes either label with the uniform
      distribution: ``(1 - ε) * label + ε / classes``.

    ``none`` returns the per-position losses, ``sum`` their sum. The loss
    is f32 for logits, the input's dtype for probabilities."""
    if reduction not in ("mean", "sum", "none"):
        raise InvalidArgumentError(f"Unknown reduction {reduction!r}")
    ax = axis % input.dim()
    n = input.shape[ax]
    logp = torch.log_softmax(input, dim=ax, dtype=torch.float32) \
        if use_softmax else torch.log(input.clamp(1e-15, 1.0))
    if soft_label or (label.dtype == input.dtype and
                      label.shape == input.shape):
        soft = label.to(logp.dtype)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n
        return _reduce(-torch.sum(soft * logp, dim=ax), reduction)
    y = label.long()
    if y.dim() == input.dim():
        y = torch.squeeze(y, ax)
    valid = y != ignore_index
    idx = torch.unsqueeze(torch.where(valid, y, torch.zeros_like(y)), ax)
    loss = -torch.squeeze(torch.gather(logp, ax, idx), ax)
    if label_smoothing > 0:
        loss = (1 - label_smoothing) * loss - \
            label_smoothing / n * torch.sum(logp, dim=ax)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        cw = torch.where(valid,
                         weight.to(loss.dtype)[torch.squeeze(idx, ax)],
                         torch.zeros_like(loss))
        loss = loss * cw
        if reduction == "mean":
            return torch.sum(loss) / torch.sum(cw).clamp(min=1e-12)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    return torch.sum(loss) / torch.sum(valid).clamp(min=1).to(loss.dtype)


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Per-position cross entropy with ``axis`` kept as a singleton
    (``reduction="none"``); with ``return_softmax``, also
    ``F.softmax(logits, axis)`` (the kernel's route, see
    ``activation.softmax``). Under ``auto_cast`` it casts where its two
    named ops cast, as the JAX package's does."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss
