"""Shape ops (port of the part of ``paddle1_tpu/ops/manip_ops.py`` that
LeNet calls; the rest of the op namespace comes later)."""

from __future__ import annotations

import torch

__all__ = ["flatten"]


def flatten(x: torch.Tensor, start_axis: int = 0, stop_axis: int = -1,
            name=None) -> torch.Tensor:
    """Merge axes ``start_axis..stop_axis`` (inclusive, negative from the
    end) into one, in row-major order whatever ``x``'s memory format."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)
