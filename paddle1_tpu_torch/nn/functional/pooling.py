"""Pooling functionals (port of every name of
``paddle1_tpu/nn/functional/pooling.py``).

The JAX package pools with XLA's ``reduce_window``, outside any Pallas
kernel, so the port leaves pooling to PyTorch's pools, which keep a
channels-last input's memory format. Padding follows the JAX package:
explicit ``(lo, hi)`` pads per spatial axis (``"SAME"`` as XLA computes
it; ``ceil_mode`` widens the high side of explicit pads, and is not read
with a string padding), padded cells never win a max, and an average
divides by the real cells of its window with ``exclusive`` (the padded
``"SAME"`` or explicit pads), else by the window's size. One-dimensional
pools run as two-dimensional ones over a unit axis.

Where the JAX package departs from Paddle's reference the port follows
it: ``divisor_override`` is taken by ``avg_pool2d``/``avg_pool3d`` and
not read; ``return_mask`` gives the flat index of each window's first
maximum over the unpadded input, its windows taken with no padding
whatever ``padding`` says; the adaptive max pools return ``(out, None)``
for ``return_mask=True``; ``max_unpool2d`` reads NCHW whatever
``data_format`` says and ignores ``padding``. ROADMAP ("Notes on the
reference") records these.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...core.errors import InvalidArgumentError
from ._layout import to_channels_last_memory
from .conv import _padding, _tuple, explicit_pads

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "lp_pool2d", "max_unpool2d"]

_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
_MAX = {2: tF.max_pool2d, 3: tF.max_pool3d}
_AVG = {2: tF.avg_pool2d, 3: tF.avg_pool3d}


def _channels_first(x, ndim, data_format):
    """``x`` as ``[N, C, *spatial]`` and whether it came channels-last;
    2-D channels-first inputs take channels-last memory inside the
    ``conv_nhwc`` region."""
    if data_format not in _FORMATS[ndim]:
        raise InvalidArgumentError(
            f"data_format must be one of {_FORMATS[ndim]}, got "
            f"{data_format!r}")
    if x.dim() != ndim + 2:
        raise InvalidArgumentError(
            f"expected a {ndim + 2}-D input, got shape {tuple(x.shape)}")
    if data_format == _FORMATS[ndim][1]:
        return torch.movedim(x, -1, 1), True
    return (to_channels_last_memory(x) if ndim == 2 else x), False


def _back(y, channel_last):
    return torch.movedim(y, 1, -1) if channel_last else y


def _pads(x, padding, k, s, ceil_mode):
    """The JAX package's ``(lo, hi)`` pads of each spatial axis of ``x``
    (channels-first)."""
    cfg = _padding(padding, len(k))
    pads = explicit_pads(cfg, x.shape[2:], k, s, (1,) * len(k))
    if ceil_mode and not isinstance(cfg, str):
        for i, (lo, hi) in enumerate(pads):
            size = int(x.shape[2 + i])
            out = -(-(size + lo + hi - k[i]) // s[i]) + 1
            pads[i] = (lo, max(hi, (out - 1) * s[i] + k[i] - size - lo))
    return cfg, [tuple(int(v) for v in p) for p in pads]


def _flat(pads):
    """``tF.pad``'s order: the last axis first."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _unit_axis(x, k, s, pads):
    """A 1-D pool's operands as a 2-D pool's, over a unit axis."""
    return (torch.unsqueeze(x, 2), (1,) + k, (1,) + s, [(0, 0)] + pads)


def _max(x, k, s, pads):
    n = len(k)
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        return _MAX[n](x, k, s, [lo for lo, _ in pads])
    fill = float("-inf") if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    return _MAX[n](tF.pad(x, _flat(pads), value=fill), k, s, 0)


def _window_sums(x, k, s, pads):
    """The sum of each window over ``x`` zero-padded by ``pads``."""
    if any(lo or hi for lo, hi in pads):
        x = tF.pad(x, _flat(pads))
    return _AVG[len(k)](x, k, s, 0, divisor_override=1)


def _avg(x, k, s, cfg, pads, exclusive):
    sums = _window_sums(x, k, s, pads)
    if exclusive and cfg != "VALID":
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        return sums / _window_sums(ones, k, s, pads)
    return sums / float(math.prod(k))


def _pool(x, kernel_size, stride, padding, ndim, mode, data_format,
          ceil_mode, exclusive=True):
    x, channel_last = _channels_first(x, ndim, data_format)
    k = _tuple(kernel_size, ndim)
    s = _tuple(stride if stride is not None else kernel_size, ndim)
    cfg, pads = _pads(x, padding, k, s, ceil_mode)
    if ndim == 1:
        x, k, s, pads = _unit_axis(x, k, s, pads)
    y = _max(x, k, s, pads) if mode == "max" else \
        _avg(x, k, s, cfg, pads, exclusive)
    if ndim == 1:
        y = torch.squeeze(y, 2)
    return _back(y, channel_last)


def _pool_mask(x, kernel_size, stride, ndim, data_format):
    """The flat spatial index (int64) of each window's first maximum,
    windows taken over the unpadded input (the JAX package's
    ``_pool_mask``)."""
    x, channel_last = _channels_first(x, ndim, data_format)
    k = _tuple(kernel_size, ndim)
    s = _tuple(stride if stride is not None else kernel_size, ndim)
    if ndim == 1:
        _, idx = tF.max_pool1d(x, k, s, 0, return_indices=True)
    else:
        _, idx = _MAX[ndim](x, k, s, 0, return_indices=True)
    return _back(idx, channel_last)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    out = _pool(x, kernel_size, stride, padding, 1, "max", data_format,
                ceil_mode)
    if return_mask:
        return out, _pool_mask(x, kernel_size, stride, 1, data_format)
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """2-D max pooling; ``stride`` defaults to ``kernel_size``."""
    out = _pool(x, kernel_size, stride, padding, 2, "max", data_format,
                ceil_mode)
    if return_mask:
        return out, _pool_mask(x, kernel_size, stride, 2, data_format)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 3, "max", data_format,
                ceil_mode)
    if return_mask:
        return out, _pool_mask(x, kernel_size, stride, 3, data_format)
    return out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", data_format,
                 ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """2-D average pooling; ``divisor_override`` is not read (module
    docstring)."""
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 ceil_mode, exclusive)


_ADAPTIVE = {("avg", 1): tF.adaptive_avg_pool1d,
             ("avg", 2): tF.adaptive_avg_pool2d,
             ("avg", 3): tF.adaptive_avg_pool3d,
             ("max", 1): tF.adaptive_max_pool1d,
             ("max", 2): tF.adaptive_max_pool2d,
             ("max", 3): tF.adaptive_max_pool3d}


def _adaptive(x, output_size, ndim, mode, data_format):
    """Adaptive pooling to ``output_size`` (an int, or one size an axis,
    ``None`` keeping that axis); windows as in Paddle, ``[floor(i * in /
    out), ceil((i + 1) * in / out))``."""
    x, channel_last = _channels_first(x, ndim, data_format)
    out = tuple(output_size) if isinstance(output_size, (list, tuple)) \
        else (output_size,)
    out = out * ndim if len(out) == 1 else out
    out = tuple(int(x.shape[2 + i]) if o is None else int(o)
                for i, o in enumerate(out))
    y = _ADAPTIVE[mode, ndim](x, out if ndim > 1 else out[0])
    return _back(y, channel_last)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive(x, output_size, 1, "max", "NCL")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive(x, output_size, 2, "max", "NCHW")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive(x, output_size, 3, "max", "NCDHW")
    return (out, None) if return_mask else out


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """``(sum over the window of |x|^p)^(1/p)``, padded cells 0."""
    p = float(norm_type)
    kk = float(math.prod(_tuple(kernel_size, 2)))
    pooled = _pool(torch.pow(torch.abs(x), p), kernel_size, stride, padding,
                   2, "avg", data_format, ceil_mode, False)
    return torch.pow(pooled * kk, 1.0 / p)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Each value of ``x`` ``[N, C, H, W]`` written at its flat index of
    ``indices`` into zeros of ``[N, C, oh, ow]``: ``output_size``'s last
    two sizes, else ``((H - 1) * stride + kernel, ...)``."""
    k = _tuple(kernel_size, 2)
    s = _tuple(stride if stride is not None else kernel_size, 2)
    n, c, h, w = (int(v) for v in x.shape)
    if output_size is not None:
        oh, ow = _tuple(output_size, 2)[-2:]
    else:
        oh, ow = (h - 1) * s[0] + k[0], (w - 1) * s[1] + k[1]
    out = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    out = torch.scatter(out, 2, torch.reshape(indices, (n, c, -1)).long(),
                        torch.reshape(x, (n, c, -1)))
    return torch.reshape(out, (n, c, oh, ow))
