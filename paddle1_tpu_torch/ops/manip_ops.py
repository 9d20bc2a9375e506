"""Shape ops (port of the part of ``paddle1_tpu/ops/manip_ops.py`` that
LeNet and YOLOv3 call; the rest of the op namespace comes later)."""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["flatten", "transpose", "concat", "stack", "split"]


def _axis(axis) -> int:
    return int(axis.item()) if isinstance(axis, torch.Tensor) else int(axis)


def transpose(x: torch.Tensor, perm: Sequence[int], name=None
              ) -> torch.Tensor:
    """Permute the axes of ``x`` to ``perm`` (a view, as ``x.permute``)."""
    return x.permute(*(int(p) for p in perm))


def flatten(x: torch.Tensor, start_axis: int = 0, stop_axis: int = -1,
            name=None) -> torch.Tensor:
    """Merge axes ``start_axis..stop_axis`` (inclusive, negative from the
    end) into one, in row-major order whatever ``x``'s memory format."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def concat(x: Sequence[torch.Tensor], axis=0, name=None) -> torch.Tensor:
    """Join the tensors of ``x`` along ``axis`` (an int or a one-element
    tensor). Inputs that share a memory format give an output in it
    (``torch.cat``): channels-last activations stay channels-last."""
    return torch.cat(list(x), dim=_axis(axis))


def stack(x: Sequence[torch.Tensor], axis: int = 0, name=None
          ) -> torch.Tensor:
    """Stack the equally shaped tensors of ``x`` along a new ``axis``."""
    return torch.stack(list(x), dim=int(axis))


def split(x: torch.Tensor, num_or_sections, axis=0, name=None
          ) -> List[torch.Tensor]:
    """Cut ``x`` along ``axis`` into ``num_or_sections`` equal parts (an
    int that divides the axis) or into parts of the listed sizes, one of
    which may be -1 (the rest). Returns a list of views."""
    axis = _axis(axis)
    dim = int(x.shape[axis])
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise InvalidArgumentError(
                f"split: axis {axis} of size {dim} is not divisible into "
                f"{num_or_sections} parts")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_axis(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = dim - sum(s for s in sizes if s >= 0)
    if sum(sizes) != dim:
        raise InvalidArgumentError(
            f"split: sections {sizes} do not add up to axis {axis}'s size "
            f"{dim}")
    return list(torch.split(x, sizes, dim=axis))
