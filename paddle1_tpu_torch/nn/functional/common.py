"""Common functionals (port of ``paddle1_tpu/nn/functional/common.py``,
its whole ``__all__``).

Each takes the JAX package's arguments in its positions; the random ones
(``dropout*``, ``alpha_dropout``) take a keyword-only ``generator`` after
them, and draw from torch's generators (the JAX package's threefry bits
cannot be reproduced, so they agree in distribution). Padding, the
shuffles, the resizes and the samplers are index arithmetic on the
device (``index_select`` / ``gather``, whose backward is the matching
scatter-add), with the JAX formulas' roundings. A named JAX op is a
``cast_point`` under its name, so ``auto_cast``'s lists see it
(``cosine_similarity`` is black-listed there).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ...amp import cast_point
from ...core.errors import InvalidArgumentError, UnimplementedError

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "pad", "zeropad2d", "cosine_similarity",
           "label_smooth", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "interpolate", "upsample", "bilinear",
           "affine_grid", "grid_sample", "fold_", "temporal_shift",
           "diag_embed", "gather_tree", "sequence_mask"]


def _ints(v) -> list:
    """A shape-like argument (a list, a tuple or a tensor) as ints."""
    if isinstance(v, torch.Tensor):
        return [int(s) for s in v.reshape(-1).tolist()]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in v]


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
    ``int(n * scale_factor)`` each). Two modes are ported:

    * ``"nearest"``: output ``i`` takes input ``floor((i + 0.5) * n_in /
      n_out)`` along each resized axis, as the reference's
      ``jax.image.resize`` does (at an integer scale that is torch's
      ``"nearest"``; at other sizes it is the half-pixel rule,
      ``"nearest-exact"``); ``align_corners`` does not enter nearest
      resizing, as in the reference. The gather runs in x's memory order,
      so a channels-first tensor with channels-last memory (the
      ``conv_nhwc`` region) gives one with channels-last memory.
    * ``"linear"``/``"bilinear"``/``"trilinear"``/``"bicubic"``/
      ``"area"`` with ``align_corners``: one axis after another, output
      ``i`` blends inputs ``floor(p)`` and ``floor(p) + 1`` at ``p = i *
      (n_in - 1) / (n_out - 1)`` (``_resize_align_corners``,
      ``common.py:274-292``, which is linear whatever the mode).
    * the same modes without ``align_corners``: the reference's
      ``jax.image.resize`` (``common.py:256-270``), half-pixel centres,
      the triangle kernel for the linear modes and ``"area"`` (mapped to
      linear, as there), Keys' cubic kernel (a = -0.5) for ``"bicubic"``,
      and, where an axis shrinks, the kernel widened by the shrink factor
      (antialiasing), so the output is not ``torch.nn.functional.
      interpolate``'s. Each resized axis is one product with its weight
      matrix (:func:`_resize_weights`, ``jax.image``'s
      ``compute_weight_mat`` in f32)."""
    if mode not in _RESIZE_KERNELS and mode != "nearest":
        raise InvalidArgumentError(
            f"interpolate: mode must be one of 'nearest', "
            f"{', '.join(repr(m) for m in _RESIZE_KERNELS)}; got {mode!r}")
    corners = mode != "nearest" and align_corners
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
    if corners:
        for ax, n_in, n_out in zip(spatial, cur, size):
            if n_in != n_out:
                x = _linear_corners(x, ax, n_in, n_out)
        return x
    if mode != "nearest":
        kernel = _RESIZE_KERNELS[mode]
        for ax, n_in, n_out in zip(spatial, cur, size):
            if n_in != n_out:
                w = _resize_weights(n_in, n_out, kernel, x.device)
                x = torch.movedim(torch.tensordot(x, w.to(x.dtype),
                                                  dims=([ax], [0])), -1, ax)
        return x
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


def _triangle(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _keys_cubic(t: torch.Tensor) -> torch.Tensor:
    t = t.abs()
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


# the reference's modes onto jax.image.resize's kernels (common.py:256-258)
_RESIZE_KERNELS = {"linear": _triangle, "bilinear": _triangle,
                   "trilinear": _triangle, "area": _triangle,
                   "bicubic": _keys_cubic}
_F32_EPS = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """The ``[n_in, n_out]`` f32 weights of one resized axis, as
    ``jax.image``'s ``compute_weight_mat`` computes them (no translation,
    antialiasing on): sample ``j`` at ``(j + 0.5) / scale - 0.5``, the
    kernel over input distances divided by ``max(1 / scale, 1)``, each
    column normalised to sum 1 (0 where its sum is below 1000 f32
    epsilons), and columns whose sample lies outside the input zero.
    Built on the host and kept per sizes, kernel and device, so a resize
    after the first launches only its contractions. Read-only:
    ``tensordot`` never writes its operands."""
    f32 = torch.float32
    scale = torch.tensor(n_out / n_in, dtype=f32)
    inv = 1.0 / scale
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
    w = kernel(dist / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _linear_corners(x, ax, n_in, n_out):
    """One axis of the align-corners linear resize, in the JAX package's
    f32 arithmetic (``linspace``, ``floor``, the upper neighbour clipped)."""
    pos = torch.linspace(0.0, n_in - 1, n_out, dtype=torch.float32,
                         device=x.device)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(0, n_in - 1)
    shape = [1] * x.dim()
    shape[ax] = n_out
    w = (pos - lo).to(x.dtype).reshape(shape)
    return torch.index_select(x, ax, lo) * (1 - w) + \
        torch.index_select(x, ax, hi) * w


def upsample(x: torch.Tensor, size=None, scale_factor=None,
             mode: str = "nearest", align_corners: bool = False,
             align_mode: int = 0, data_format: str = "NCHW", name=None
             ) -> torch.Tensor:
    """:func:`interpolate` under Paddle's other name."""
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    """Whole channels dropped: :func:`dropout` along the batch and
    channel axes."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, *,
                  generator: Optional[torch.Generator] = None):
    """SELU-preserving dropout: dropped elements take ``-alpha * scale``,
    then ``a * x + b`` restores the mean and variance (the JAX package's
    ``a`` and ``b``)."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    keep.bernoulli_(1.0 - p, generator=generator)
    y = torch.where(keep.bool(), x, torch.full((), alpha_p, dtype=x.dtype,
                                               device=x.device))
    return (a * y + b).to(x.dtype)


@cast_point("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; with ``padding_idx >= 0`` the
    rows of ids equal to it are zero, and so is that row's gradient (the
    output is multiplied by the keep mask, as in the JAX package).
    ``sparse=True`` (sparse gradients) is not ported and raises (ROADMAP
    Queue 1 item 8, the recommender slice)."""
    if sparse:
        raise UnimplementedError(
            "embedding: sparse gradients (sparse=True) are not ported "
            "(ROADMAP Queue 1 item 8)")
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is None or padding_idx < 0:
        return out
    return out * (x != padding_idx).unsqueeze(-1).to(out.dtype)


@cast_point("one_hot")
def one_hot(x, num_classes, name=None):
    """float32 ``[..., num_classes]``, 1 where the class is the id (an id
    outside ``[0, num_classes)`` gives a row of zeros, as
    ``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.long().unsqueeze(-1) == classes).to(torch.float32)


def _pad_spec(pad, nd, data_format):
    """``[(lo, hi)]`` per dim of Paddle's ``pad`` list (the JAX package's
    rule: ``2 * nd`` entries pair the dims in order; fewer pad the
    trailing spatial dims, the last one first)."""
    cfg = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    n_spatial = len(pad) // 2
    if data_format.startswith("NC"):
        axes = list(range(nd - n_spatial, nd))
    else:
        axes = list(range(nd - 1 - n_spatial, nd - 1))
    for i, ax in enumerate(reversed(axes)):
        cfg[ax] = (pad[2 * i], pad[2 * i + 1])
    return cfg


def _pad_index(n, lo, hi, mode, device):
    """Source index of each of ``lo + n + hi`` outputs along one axis for
    numpy's ``edge``, ``wrap`` and ``reflect`` modes."""
    j = np.arange(-lo, n + hi)
    if mode == "replicate":
        j = np.clip(j, 0, n - 1)
    elif mode == "circular":
        j = np.mod(j, n)
    else:
        period = 2 * (n - 1)
        j = np.abs(j) % period if period else np.zeros_like(j)
        j = np.where(j >= n, period - j, j)
    return torch.as_tensor(j, dtype=torch.long, device=device)


@cast_point("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's ``pad``: ``constant`` (``value``), ``reflect``,
    ``replicate`` or ``circular``, the pads read by the JAX package's rule
    (:func:`_pad_spec`)."""
    if mode not in ("constant", "reflect", "replicate", "circular"):
        raise InvalidArgumentError(f"pad: unknown mode {mode!r}")
    cfg = _pad_spec(_ints(pad), x.dim(), data_format)
    if mode == "constant":
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = torch.index_select(
                x, ax, _pad_index(int(x.shape[ax]), lo, hi, mode, x.device))
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


@cast_point("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(x1 * x2) / max(|x1| |x2|, eps)`` along ``axis``."""
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


@cast_point("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon * prior`` (uniform ``1 / C``
    without ``prior_dist``)."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@cast_point("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        y = x.reshape(n, c // (r * r), r, r, h, w)
        return y.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r,
                                                   w * r)
    n, h, w, c = x.shape
    y = x.reshape(n, h, w, r, r, c // (r * r))
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


@cast_point("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """NCHW only, as in the JAX package (``data_format`` is not read)."""
    r = downscale_factor
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // r, r, w // r, r)
    return y.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)


@cast_point("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """NCHW only, as in the JAX package (``data_format`` is not read)."""
    n, c, h, w = x.shape
    y = x.reshape(n, groups, c // groups, h, w)
    return y.transpose(1, 2).reshape(n, c, h, w)


@cast_point("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] . weight[o] . x2[b] (+ bias[o])``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


@cast_point("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """float32 ``[N, H, W, 2]`` sampling grid: ``theta [N, 2, 3]`` applied
    to the ``(x, y, 1)`` of each output pixel, the pixel centres in
    ``[-1, 1]`` (the corners at +-1 with ``align_corners``)."""
    n, _, h, w = _ints(out_shape)[:4]
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev)
        xs = torch.linspace(-1, 1, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) + 0.5) * 2 / h - 1
        xs = (torch.arange(w, device=dev) + 0.5) * 2 / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    grid = torch.einsum("nij,pj->npi", theta.to(torch.float32), base)
    return grid.reshape(n, h, w, 2)


@cast_point("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x [N, C, H, W]`` at ``grid [N, Ho, Wo, 2]`` (x, y in
    ``[-1, 1]``): ``bilinear`` blends the four neighbours, ``nearest``
    takes the rounded one (half to even); outside the image a neighbour
    is 0 (``zeros``) or the clipped border pixel. Gradients flow to ``x``
    and to ``grid``, as in the JAX package."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    flat = x.reshape(n, c, h * w)
    out_hw = fx.shape[1:]

    def at(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, 1, -1)
        v = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        v = v.reshape(n, c, *out_hw)
        if padding_mode == "zeros":
            v = torch.where(valid[:, None], v, torch.zeros((), dtype=v.dtype,
                                                           device=v.device))
        return v
    if mode == "nearest":
        return at(torch.round(fy).long(), torch.round(fx).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
    return (at(y0, x0) * (1 - wx) * (1 - wy) +
            at(y0, x0 + 1) * wx * (1 - wy) +
            at(y0 + 1, x0) * (1 - wx) * wy +
            at(y0 + 1, x0 + 1) * wx * wy)


def fold_(*args, **kwargs):
    """:func:`~.conv.fold` under the JAX module's name."""
    from .conv import fold
    return fold(*args, **kwargs)


@cast_point("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift: of ``[N*T, C, H, W]``, the first ``C * shift_ratio``
    channels move one segment back in time, the next as many one forward,
    zeros filling in."""
    nt, c, h, w = x.shape
    y = x.reshape(nt // seg_num, seg_num, c, h, w)
    k = int(c * shift_ratio)
    left = torch.cat([y[:, 1:, :k], torch.zeros_like(y[:, :1, :k])], 1)
    right = torch.cat([torch.zeros_like(y[:, :1, k:2 * k]),
                       y[:, :-1, k:2 * k]], 1)
    return torch.cat([left, right, y[:, :, 2 * k:]], 2).reshape(nt, c, h, w)


@cast_point("diag_embed")
def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """The last axis of ``input`` on the ``offset`` diagonal of a new
    square pair of axes at ``(dim1, dim2)``."""
    return torch.diag_embed(input, offset, dim1, dim2)


def gather_tree(ids, parents):
    """Back-trace beam search: ``ids``/``parents`` ``[T, B, beam]`` →
    the full sequence that ends in each final beam, step by step from the
    last (``paddle1_tpu/nn/functional/common.py:gather_tree``)."""
    t_len = ids.shape[0]
    beam = torch.arange(ids.shape[-1], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    out = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        idx = beam.long()
        out[t] = torch.gather(ids[t], -1, idx)
        beam = torch.gather(parents[t], -1, idx)
    return torch.stack(out, 0)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths ``[B]`` → ``[B, maxlen]`` mask, 1 before each length
    (``maxlen`` None: the longest length, read on the host)."""
    from ...core.dtype import convert_dtype
    ml = int(x.max()) if maxlen is None else int(maxlen)
    ids = torch.arange(ml, device=x.device)
    return (ids[None, :] < x[:, None]).to(convert_dtype(dtype))
