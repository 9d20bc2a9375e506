"""Pooling functionals (port of ``max_pool2d`` and
``adaptive_avg_pool2d`` from ``paddle1_tpu/nn/functional/pooling.py``).

The JAX package pools with XLA's ``reduce_window``, outside any Pallas
kernel, so the port leaves pooling to PyTorch's ``F.max_pool2d`` and
``F.adaptive_avg_pool2d``, which keep a channels-last input's memory
format. Padding follows the JAX package: explicit ``(lo, hi)`` pads
(``ceil_mode`` widens the high side), padded cells never win a max.
"""

from __future__ import annotations

import torch.nn.functional as tF

from ...core.errors import InvalidArgumentError, UnimplementedError
from ._layout import to_channels_last_memory
from .conv import _padding, _tuple, explicit_pads

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def _nchw(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise InvalidArgumentError(
            f"data_format must be NCHW or NHWC, got {data_format!r}")
    if x.dim() != 4:
        raise InvalidArgumentError(
            f"expected a 4-D input, got shape {tuple(x.shape)}")
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2), True
    return to_channels_last_memory(x), False


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """2-D max pooling; ``stride`` defaults to ``kernel_size``."""
    if return_mask:
        raise UnimplementedError(
            "max_pool2d(return_mask=True) is not ported yet")
    x, channel_last = _nchw(x, data_format)
    k = _tuple(kernel_size, 2)
    s = _tuple(stride if stride is not None else kernel_size, 2)
    pads = explicit_pads(_padding(padding, 2), x.shape[2:], k, s, (1, 1))
    if ceil_mode:
        for i, (lo, hi) in enumerate(pads):
            size = int(x.shape[2 + i])
            out = -(-(size + lo + hi - k[i]) // s[i]) + 1
            pads[i] = (lo, max(hi, (out - 1) * s[i] + k[i] - size - lo))
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        y = tF.max_pool2d(x, k, s, [lo for lo, _ in pads])
    else:
        (t, b), (lft, r) = pads
        y = tF.max_pool2d(tF.pad(x, (lft, r, t, b), value=float("-inf")),
                          k, s, 0)
    return y.permute(0, 2, 3, 1) if channel_last else y


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Adaptive average pooling to ``output_size`` (an int, a pair, or a
    pair with ``None`` for "keep this size"); windows as in Paddle,
    ``[floor(i * in / out), ceil((i + 1) * in / out))``."""
    x, channel_last = _nchw(x, data_format)
    out = tuple(output_size) if isinstance(output_size, (list, tuple)) \
        else (output_size,)
    out = out * 2 if len(out) == 1 else out
    out = tuple(int(x.shape[2 + i]) if o is None else int(o)
                for i, o in enumerate(out))
    y = tF.adaptive_avg_pool2d(x, out)
    return y.permute(0, 2, 3, 1) if channel_last else y
