"""Functional image transforms over HWC numpy arrays (reference
python/paddle/vision/transforms/functional.py + functional_cv2.py).

Port of ``paddle1_tpu/vision/transforms/functional.py``. These run on the
HOST inside DataLoader workers (the reference does the same with
cv2/PIL); device-side augmentation belongs in the step. Arrays are HWC
uint8/float32; CHW tensors come out of ``to_tensor`` at the end of the
pipeline. ``to_tensor`` and ``normalize`` of a tensor return port tensors
on the current place, which inside a DataLoader (its threads and worker
processes) is the CPU.
"""

from __future__ import annotations

import numbers
from typing import Sequence

import numpy as np
import torch

__all__ = ["to_tensor", "normalize", "resize", "crop", "center_crop",
           "hflip", "vflip", "pad", "rotate", "adjust_brightness",
           "adjust_contrast", "adjust_saturation", "adjust_hue",
           "to_grayscale"]


def _as_hwc(img) -> np.ndarray:
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def to_tensor(img, data_format="CHW"):
    """HWC uint8 [0,255] → float32 [0,1] tensor (reference
    functional.to_tensor)."""
    from ...core.tensor import to_tensor as tt
    arr = _as_hwc(img)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    return tt(arr)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    if isinstance(img, torch.Tensor):
        arr = img.detach().as_subclass(torch.Tensor).cpu().numpy()
    else:
        arr = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    out = (arr - mean) / std
    if isinstance(img, torch.Tensor):
        from ...core.tensor import to_tensor as tt
        return tt(out)
    return out


def _interp_resize(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize via vectorized numpy (no cv2 dependency)."""
    H, W = arr.shape[:2]
    if (H, W) == (h, w):
        return arr
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = arr.astype(np.float32)
    top = a[y0][:, x0] * (1 - wx) + a[y0][:, x1] * wx
    bot = a[y1][:, x0] * (1 - wx) + a[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(arr.dtype, np.floating):
        return out.astype(arr.dtype)
    return np.clip(out + 0.5, 0, 255).astype(arr.dtype)


def resize(img, size, interpolation="bilinear"):
    arr = _as_hwc(img)
    if isinstance(size, numbers.Number):
        H, W = arr.shape[:2]
        if H <= W:
            h, w = int(size), int(size * W / H)
        else:
            h, w = int(size * H / W), int(size)
    else:
        h, w = size
    return _interp_resize(arr, int(h), int(w))


def crop(img, top, left, height, width):
    arr = _as_hwc(img)
    return arr[top:top + height, left:left + width]


def center_crop(img, output_size):
    arr = _as_hwc(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = output_size
    H, W = arr.shape[:2]
    top = max(0, (H - h) // 2)
    left = max(0, (W - w) // 2)
    return crop(arr, top, left, h, w)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = [int(p) for p in padding]
    width = ((pt, pb), (pl, pr), (0, 0))
    if padding_mode == "constant":
        return np.pad(arr, width, mode="constant", constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(arr, width, mode=mode)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Nearest-neighbor rotation (reference functional.rotate). Host-side
    augmentation only."""
    arr = _as_hwc(img)
    H, W = arr.shape[:2]
    theta = -np.deg2rad(angle)
    cy, cx = ((H - 1) / 2, (W - 1) / 2) if center is None else center
    yy, xx = np.mgrid[0:H, 0:W]
    ys = cy + (yy - cy) * np.cos(theta) - (xx - cx) * np.sin(theta)
    xs = cx + (yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
    yi = np.round(ys).astype(int)
    xi = np.round(xs).astype(int)
    valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    out = np.full_like(arr, fill)
    out[valid] = arr[yi[valid], xi[valid]]
    return out


def adjust_brightness(img, factor):
    arr = _as_hwc(img).astype(np.float32) * factor
    return np.clip(arr, 0, 255).astype(np.uint8) \
        if np.asarray(img).dtype == np.uint8 else arr


def adjust_contrast(img, factor):
    arr = _as_hwc(img).astype(np.float32)
    mean = arr.mean()
    out = (arr - mean) * factor + mean
    return np.clip(out, 0, 255).astype(np.uint8) \
        if np.asarray(img).dtype == np.uint8 else out


def adjust_saturation(img, factor):
    arr = _as_hwc(img).astype(np.float32)
    gray = arr.mean(axis=2, keepdims=True)
    out = gray + (arr - gray) * factor
    return np.clip(out, 0, 255).astype(np.uint8) \
        if np.asarray(img).dtype == np.uint8 else out


def adjust_hue(img, factor):
    """Hue shift in HSV space, factor ∈ [-0.5, 0.5]."""
    arr = _as_hwc(img)
    dtype = arr.dtype
    a = arr.astype(np.float32) / (255.0 if dtype == np.uint8 else 1.0)
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    mx, mn = a.max(-1), a.min(-1)
    diff = mx - mn + 1e-12
    h = np.zeros_like(mx)
    m = mx == r
    h[m] = ((g - b)[m] / diff[m]) % 6
    m = mx == g
    h[m] = (b - r)[m] / diff[m] + 2
    m = mx == b
    h[m] = (r - g)[m] / diff[m] + 4
    h = (h / 6.0 + factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0)
    v = mx
    i = np.floor(h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    lut = np.stack([np.stack([v, t, p], -1), np.stack([q, v, p], -1),
                    np.stack([p, v, t], -1), np.stack([p, q, v], -1),
                    np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    out = np.take_along_axis(lut, i[None, ..., None], axis=0)[0]
    if dtype == np.uint8:
        return np.clip(out * 255 + 0.5, 0, 255).astype(np.uint8)
    return out.astype(dtype)


def to_grayscale(img, num_output_channels=1):
    arr = _as_hwc(img).astype(np.float32)
    gray = (arr[..., :3] * np.array([0.299, 0.587, 0.114])).sum(-1,
                                                                keepdims=True)
    gray = np.repeat(gray, num_output_channels, axis=2)
    return gray.astype(np.asarray(img).dtype) \
        if np.asarray(img).dtype != np.uint8 else \
        np.clip(gray + 0.5, 0, 255).astype(np.uint8)
