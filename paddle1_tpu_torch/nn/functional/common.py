"""Common functionals (port of ``linear``, ``dropout``, ``interpolate``
and ``upsample`` from ``paddle1_tpu/nn/functional/common.py``)."""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...amp import cast_point
from ...core.errors import InvalidArgumentError, UnimplementedError

__all__ = ["linear", "dropout", "interpolate", "upsample"]


@cast_point("linear")
def linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
           name=None) -> torch.Tensor:
    """``x @ weight + bias`` with Paddle's ``[in_features, out_features]``
    weight (``paddle1_tpu/nn/functional/common.py:34-41``)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias

_DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x: torch.Tensor, p: float = 0.5, axis=None,
            training: bool = True, mode: str = "upscale_in_train",
            name=None, *, generator: Optional[torch.Generator] = None
            ) -> torch.Tensor:
    """Paddle's dropout. In training each element is kept with
    probability ``1 - p``: ``upscale_in_train`` scales the kept ones by
    ``1 / (1 - p)``, ``downscale_in_infer`` leaves them; with ``axis``
    (an int or a list) one keep mask of x's size along those axes is
    broadcast along the others, so whole slices are kept or dropped. Out
    of training ``upscale_in_train`` (and any mode at ``p == 0``) returns
    ``x`` as it is and ``downscale_in_infer`` scales it by ``1 - p``. The
    keep mask is drawn from ``generator`` (the default generator of x's
    device when None); it cannot reproduce the JAX package's bits, so
    tests compare structure, p = 0 or distributions."""
    if mode not in _DROPOUT_MODES:
        raise InvalidArgumentError(
            f"dropout: mode must be one of {_DROPOUT_MODES}, got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.empty(shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1.0 - p, generator=generator)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep.bool(), kept,
                       torch.zeros((), dtype=x.dtype, device=x.device))


@functools.lru_cache(maxsize=64)
def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """The source index of each of ``n_out`` outputs along one axis of
    ``n_in``: ``floor((i + 0.5) * n_in / n_out)`` in f32, the half-pixel
    rule and the arithmetic of the reference's
    ``jax.image.resize(method="nearest")`` (IEEE f32 on either device, so
    computed where it is used, with no copy from the host). Kept per
    sizes and device: a forward reuses its indices and launches only the
    gathers. Read-only: ``index_select`` never writes its index."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(pos).to(torch.long)


def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest", align_corners: bool = False,
                align_mode: int = 0, data_format: str = "NCHW", name=None
                ) -> torch.Tensor:
    """Resize the spatial axes of ``x`` to ``size`` (or to
    ``int(n * scale_factor)`` each). Only ``mode="nearest"`` is ported:
    output ``i`` takes input ``floor((i + 0.5) * n_in / n_out)`` along
    each resized axis, as the reference's ``jax.image.resize`` does (at
    an integer scale that is torch's ``"nearest"``; at other sizes it is
    the half-pixel rule, ``"nearest-exact"``); ``align_corners`` does not
    enter nearest resizing, as in the reference. The gather runs in x's
    memory order, so a channels-first tensor with channels-last memory
    (the ``conv_nhwc`` region) gives one with channels-last memory."""
    if mode != "nearest":
        raise UnimplementedError(
            f"interpolate: mode={mode!r} is not ported (only 'nearest')")
    channel_last = data_format in ("NHWC", "NWC", "NDHWC")
    nd = x.dim()
    if nd < 3:
        raise InvalidArgumentError(
            f"interpolate: x must have a batch, a channel and spatial "
            f"axes, got shape {tuple(x.shape)}")
    spatial = list(range(1, nd - 1)) if channel_last else list(range(2, nd))
    cur = [int(x.shape[a]) for a in spatial]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.reshape(-1).tolist()
        size = [int(s) for s in (size if isinstance(size, (list, tuple))
                                 else [size])]
    else:
        if scale_factor is None:
            raise InvalidArgumentError(
                "interpolate: one of size and scale_factor must be given")
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(c * s) for c, s in zip(cur, scale_factor)]
    if len(size) != len(spatial):
        raise InvalidArgumentError(
            f"interpolate: size {size} does not match the {len(spatial)} "
            f"spatial axes of x {tuple(x.shape)}")
    # gather along the spatial axes of the tensor as it lies in memory: a
    # channels-first tensor with channels-last strides is gathered through
    # its channels-last view (index_select returns contiguous memory)
    perm = None
    if not channel_last and not x.is_contiguous() and nd in (4, 5) and \
            x.permute(0, *range(2, nd), 1).is_contiguous():
        perm = (0, *range(2, nd), 1)
        x = x.permute(perm)
        spatial = list(range(1, nd - 1))
    for ax, n_in, n_out in zip(spatial, cur, size):
        if n_in != n_out:
            x = torch.index_select(
                x, dim=ax, index=_nearest_index(n_in, n_out, x.device))
    if perm is not None:
        x = x.permute(0, nd - 1, *range(1, nd - 1))
    return x


def upsample(x: torch.Tensor, size=None, scale_factor=None,
             mode: str = "nearest", align_corners: bool = False,
             align_mode: int = 0, data_format: str = "NCHW", name=None
             ) -> torch.Tensor:
    """:func:`interpolate` under Paddle's other name."""
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)
