"""Normalization functionals (port of ``layer_norm`` from
``paddle1_tpu/nn/functional/norm.py``)."""

from __future__ import annotations

import math

import torch

from ...core.errors import InvalidArgumentError
from ...core.flags import flag_active
from ...ops import layer_norm as ln

__all__ = ["layer_norm"]


def layer_norm(x: torch.Tensor, normalized_shape, weight: torch.Tensor,
               bias: torch.Tensor, epsilon: float = 1e-05) -> torch.Tensor:
    """Affine LayerNorm over the trailing ``normalized_shape`` axes, which
    are flattened into one (``weight``/``bias`` likewise). Under
    ``fused_layer_norm`` (``auto`` = CUDA tensors) the kernel's wrapper
    runs under an autograd function whose backward is the plain formula,
    and raises on inputs outside the kernel's contract; otherwise the
    plain version runs under PyTorch's autograd."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = tuple(int(s) for s in normalized_shape)
    lead = tuple(x.shape[:x.dim() - len(shape)])
    if not shape or tuple(x.shape[len(lead):]) != shape:
        raise InvalidArgumentError(
            f"layer_norm: normalized_shape {list(shape)} is not the "
            f"trailing shape of x {tuple(x.shape)}")
    fn = ln.layer_norm if flag_active("fused_layer_norm", x.device) \
        else ln.layer_norm_ref
    n = math.prod(shape)
    y = fn(x.reshape(*lead, n), weight.reshape(n), bias.reshape(n), epsilon)
    return y.reshape(x.shape)
