"""Convolution functionals (port of ``paddle1_tpu/nn/functional/conv.py``:
``conv1d/2d/3d``, their transposes, ``unfold`` and ``fold``).

The JAX package computes convolutions with XLA's
``conv_general_dilated``, outside any Pallas kernel, so the port leaves
them to PyTorch's ``F.conv*d`` / ``F.conv_transpose*d`` (cuDNN on the
card), as it leaves matrix products to ``torch.matmul``. Paddle's weight
layouts are PyTorch's: ``[O, I/groups, *k]`` for a convolution, ``[I,
O/groups, *k]`` for a transposed one. Inside the channels-last region
(``conv_nhwc``) a 4-D or 5-D input is given channels-last memory, and
cuDNN returns the output in it.

A transposed convolution is the JAX package's gradient-of-conv form: the
input dilated by the stride, padded ``k - 1 - lo`` before and ``k - 1 -
hi + output_padding`` after (``k`` the dilated kernel), so the output is
``(L - 1) * stride + k - lo - hi + output_padding`` long; ``"SAME"`` is
``lo = (k - 1) // 2``, ``hi = k - 1 - lo`` and ``"VALID"`` no padding
(the JAX package's rules, ``conv.py:133-174``). Where PyTorch's own
arguments express that (``lo == hi``, ``output_padding`` below the
stride or the dilation) one call computes it; otherwise the unpadded
transpose is cropped and zero-extended to the same window.
``output_size`` is accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...amp import cast_point
from ...core.errors import InvalidArgumentError
from ._layout import to_channels_last_memory

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "unfold", "fold"]

# spatial dims -> (channels-first, channels-last) data formats
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


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


def _torch_pads(pads):
    """``[(lo, hi)]`` per spatial dim as ``F.pad``'s list (last dim
    first)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _channels_first(x, data_format, n, op):
    """``x`` in channels-first order for PyTorch's call, and whether the
    caller's layout was channels-last."""
    first, last = _FORMATS[n]
    if data_format not in (first, last):
        raise InvalidArgumentError(
            f"{op}: data_format must be {first} or {last}, got "
            f"{data_format!r}")
    if x.dim() != n + 2:
        raise InvalidArgumentError(
            f"{op}: x must be {n + 2}-D, got shape {tuple(x.shape)}")
    if data_format == last:
        return x.movedim(-1, 1), True
    return (to_channels_last_memory(x) if n > 1 else x), False


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format,
          n, op):
    x, channel_last = _channels_first(x, data_format, n, op)
    stride, dilation = _tuple(stride, n), _tuple(dilation, n)
    pads = explicit_pads(_padding(padding, n), x.shape[2:],
                         weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        out = _CONV[n](x, weight, bias, stride, [lo for lo, _ in pads],
                       dilation, groups)
    else:
        out = _CONV[n](tF.pad(x, _torch_pads(pads)), weight, bias, stride,
                       0, dilation, groups)
    return out.movedim(1, -1) if channel_last else out


@cast_point("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution: ``x`` NCL (or NLC), ``weight`` ``[O, I/groups,
    k]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1, "conv1d")


@cast_point("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, Paddle's API: ``x`` NCHW (or NHWC with
    ``data_format="NHWC"``), ``weight`` ``[O, I/groups, kh, kw]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2, "conv2d")


@cast_point("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution: ``x`` NCDHW (or NDHWC), ``weight`` ``[O, I/groups,
    kd, kh, kw]``."""
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3, "conv3d")


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n, op):
    """The transposed convolution of the module docstring."""
    x, channel_last = _channels_first(x, data_format, n, op)
    stride, dilation = _tuple(stride, n), _tuple(dilation, n)
    out_pad = _tuple(output_padding, n)
    k = [(int(weight.shape[2 + i]) - 1) * dilation[i] + 1 for i in range(n)]
    pad = _padding(padding, n)
    if pad == "SAME":
        pads = [((ki - 1) // 2, ki - 1 - (ki - 1) // 2) for ki in k]
    elif pad == "VALID":
        pads = [(0, 0)] * n
    elif isinstance(pad, str):
        raise InvalidArgumentError(f"Bad padding spec: {pad!r}")
    else:
        pads = [(int(lo), int(hi)) for lo, hi in pad]
    if all(lo == hi and lo >= 0 and op < max(s, d) for (lo, hi), op, s, d
           in zip(pads, out_pad, stride, dilation)):
        out = _CONV_T[n](x, weight, bias, stride, [lo for lo, _ in pads],
                         out_pad, groups, dilation)
    else:
        out = _CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
        # crop lo before and hi - output_padding after (negative: zeros)
        out = tF.pad(out, _torch_pads([(-lo, op - hi) for (lo, hi), op
                                       in zip(pads, out_pad)]))
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * n)
    return out.movedim(1, -1) if channel_last else out


@cast_point("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """1-D transposed convolution, ``weight`` ``[I, O/groups, k]``."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 1,
                           "conv1d_transpose")


@cast_point("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """2-D transposed convolution, ``weight`` ``[I, O/groups, kh, kw]``."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2,
                           "conv2d_transpose")


@cast_point("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """3-D transposed convolution, ``weight`` ``[I, O/groups, kd, kh,
    kw]``."""
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3,
                           "conv3d_transpose")


@cast_point("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` → ``[N, C * kh * kw, L]``, the channel
    axis ordered (C, kh, kw) as the JAX package's patches; any padding
    spec ``conv2d`` takes (asymmetric pairs, ``"SAME"``/``"VALID"``)."""
    k, s, d = _tuple(kernel_sizes, 2), _tuple(strides, 2), \
        _tuple(dilations, 2)
    pads = explicit_pads(_padding(paddings, 2), x.shape[2:], k, s, d)
    return tF.unfold(tF.pad(x, _torch_pads(pads)), k, d, 0, s)


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
