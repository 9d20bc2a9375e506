"""Convolution functionals (port of ``conv2d``, ``unfold`` and ``fold``
from ``paddle1_tpu/nn/functional/conv.py``).

The JAX package computes convolutions with XLA's
``conv_general_dilated``, outside any Pallas kernel, so the port leaves
them to PyTorch's ``F.conv2d`` (cuDNN on the card), as it leaves matrix
products to ``torch.matmul``. Paddle's weight layout ``[O, I/groups, kh,
kw]`` is PyTorch's. Inside the channels-last region (``conv_nhwc``) the
input is given channels-last memory, and cuDNN returns the output in it.
"""

from __future__ import annotations

import torch.nn.functional as tF

from ...amp import cast_point
from ...core.errors import InvalidArgumentError
from ._layout import to_channels_last_memory

__all__ = ["conv2d", "unfold", "fold"]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _padding(padding, n):
    """Paddle's padding spec -> ``"SAME"``, ``"VALID"`` or ``[(lo, hi)] *
    n`` (the JAX package's normalisation)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(int(q) for q in p) for p in padding]
    raise InvalidArgumentError(f"Bad padding spec: {padding!r}")


def explicit_pads(pad, sizes, kernel, stride, dilation):
    """``[(lo, hi)]`` per spatial dim for a normalised padding spec,
    ``"SAME"`` as XLA computes it (output ceil(in / stride), the odd
    padding unit at the end)."""
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        out = []
        for n, k, s, d in zip(sizes, kernel, stride, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(pad, str):
        raise InvalidArgumentError(f"Bad padding spec: {pad!r}")
    return list(pad)


@cast_point("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, Paddle's API: ``x`` NCHW (or NHWC with
    ``data_format="NHWC"``), ``weight`` ``[O, I/groups, kh, kw]``."""
    if data_format not in ("NCHW", "NHWC"):
        raise InvalidArgumentError(
            f"conv2d: data_format must be NCHW or NHWC, got {data_format!r}")
    if x.dim() != 4:
        raise InvalidArgumentError(
            f"conv2d: x must be 4-D, got shape {tuple(x.shape)}")
    stride = _tuple(stride, 2)
    dilation = _tuple(dilation, 2)
    channel_last = data_format == "NHWC"
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    else:
        x = to_channels_last_memory(x)
    pads = explicit_pads(_padding(padding, 2), x.shape[2:],
                         weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        out = tF.conv2d(x, weight, bias, stride, [lo for lo, _ in pads],
                        dilation, groups)
    else:
        (t, b), (lft, r) = pads
        out = tF.conv2d(tF.pad(x, (lft, r, t, b)), weight, bias, stride, 0,
                        dilation, groups)
    return out.permute(0, 2, 3, 1) if channel_last else out


@cast_point("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` → ``[N, C * kh * kw, L]``, the channel
    axis ordered (C, kh, kw) as the JAX package's patches; any padding
    spec ``conv2d`` takes (asymmetric pairs, ``"SAME"``/``"VALID"``)."""
    k, s, d = _tuple(kernel_sizes, 2), _tuple(strides, 2), \
        _tuple(dilations, 2)
    (t, b), (lft, r) = explicit_pads(_padding(paddings, 2), x.shape[2:], k,
                                     s, d)
    return tF.unfold(tF.pad(x, (lft, r, t, b)), k, d, 0, s)


@cast_point("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold`: the columns ``[N, C * kh *
    kw, L]`` summed into ``[N, C, *output_sizes]``."""
    k, s, d = _tuple(kernel_sizes, 2), _tuple(strides, 2), \
        _tuple(dilations, 2)
    oh, ow = _tuple(output_sizes, 2)
    (t, b), (lft, r) = explicit_pads(_padding(paddings, 2), (oh, ow), k, s,
                                     d)
    y = tF.fold(x, (oh + t + b, ow + lft + r), k, d, 0, s)
    return y[:, :, t:t + oh, lft:lft + ow]
