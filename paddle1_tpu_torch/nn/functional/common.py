"""Common functionals (port of ``dropout`` from
``paddle1_tpu/nn/functional/common.py``)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dropout"]


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Paddle's ``upscale_in_train`` dropout: in training each element is
    kept with probability ``1 - p`` and scaled by ``1 / (1 - p)``; out of
    training, or at ``p == 0``, ``x`` is returned as it is. The keep mask
    is drawn from ``generator`` (the default generator of x's device when
    None); it cannot reproduce the JAX package's bits, so tests compare at
    p = 0 or compare distributions."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1.0 - p, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))
