"""The channels-last execution region (port of
``paddle1_tpu/nn/functional/_layout.py``).

Under the ``conv_nhwc`` flag (``auto``: CUDA tensors) the NCHW-API image
ops (conv2d, max/adaptive-average pooling, batch norm) run on
channels-last MEMORY: ``torch.channels_last`` for 4-D tensors,
``torch.channels_last_3d`` for 5-D ones. The API stays NCHW: a tensor's
logical shape is ``[N, C, H, W]`` throughout, and only its strides
change. The JAX package transposes at each op boundary and relies on XLA
to cancel the pairs; here the memory format carries over from op to op
(cuDNN's convolutions and PyTorch's pooling and elementwise ops keep it),
so inside a ResNet only the stem input is converted, once, and the
batch-norm kernels read ``x.permute(0, 2, 3, 1).reshape(-1, C)`` as a
free view.

This module is the one definition of the region's eligibility rule and
of the pair of views, so the participating ops cannot drift apart.
"""

from __future__ import annotations

import torch

from ...core.flags import flag_active

__all__ = ["channels_last_region", "to_channels_last_memory",
           "channels_last_weights"]

_identity = lambda t: t   # noqa: E731

# x_ndim -> (to channels-last order, back to channels-first order)
_PERMS = {
    3: ((0, 2, 1), (0, 2, 1)),                      # NCL  <-> NLC
    4: ((0, 2, 3, 1), (0, 3, 1, 2)),                # NCHW <-> NHWC
    5: ((0, 2, 3, 4, 1), (0, 4, 1, 2, 3)),          # NCDHW<->NDHWC
}
_FORMATS = {4: torch.channels_last, 5: torch.channels_last_3d}


def channels_last_region(x_ndim: int, channel_last: bool, device):
    """Resolve the region for one op on a tensor of rank ``x_ndim`` on
    ``device``. Returns ``(active, to_internal, from_internal)``: when
    active, ``to_internal(t)`` is ``t`` as a contiguous channels-last
    tensor in channels-last ORDER (``[N, H, W, C]``; free when ``t``
    already has channels-last memory, one copy otherwise, which is the
    region's boundary) and ``from_internal(y)`` the channels-first view
    of such a tensor (free). Only channels-first tensors with a batch
    dim, a channel dim and 1-3 spatial dims take part."""
    if channel_last or x_ndim not in _PERMS or \
            not flag_active("conv_nhwc", device):
        return False, _identity, _identity
    fwd, bwd = _PERMS[x_ndim]
    fmt = _FORMATS.get(x_ndim)

    def to_internal(t):
        if fmt is None:          # 3-D: no memory format of its own
            return t.permute(fwd).contiguous()
        return t.contiguous(memory_format=fmt).permute(fwd)

    return True, to_internal, lambda t: t.permute(bwd)


def to_channels_last_memory(x):
    """``x`` (channels-first order) with channels-last memory when the
    region is active for it, else ``x``: the input side of conv and
    pooling, whose PyTorch calls keep the memory format they are given."""
    active, to_internal, from_internal = channels_last_region(
        x.dim(), False, x.device)
    return from_internal(to_internal(x)) if active else x


def channels_last_weights(module: torch.nn.Module) -> torch.nn.Module:
    """Give every 4-D parameter of ``module`` (conv weights) channels-last
    memory where the region is active for its device, in place; returns
    ``module``. cuDNN computes a channels-last convolution on a
    channels-last weight: a ``[O, I, kh, kw]`` weight held channels-first
    is converted on every call (a 1 x 1 weight is both), so an inference
    model whose weights every forward reads keeps them in the region's
    format. The logical shape, and so the state dict, is unchanged."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 4 and channels_last_region(4, False,
                                                     p.device)[0]:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
    return module
