"""Detection ops (port of the part of ``paddle1_tpu/vision/ops.py`` that
YOLOv3 inference runs: ``iou``, ``yolo_box``, ``nms``,
``multiclass_nms`` and the helpers they call).

``yolo_box`` is tensor code and runs where its input lies (the card, on
the inference path). The non-maximum suppressions run on the host in
numpy, as the reference's eager arms do: greedy NMS is a loop of small
dependent steps, so each image's boxes are copied to the host once and
every class is suppressed there, with no per-class device round trip.
The numpy helpers are the reference's, line for line, so identical
inputs give identical kept sets (greedy NMS can reorder under a 1e-6
change near a tie or the threshold).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["iou", "yolo_box", "nms", "multiclass_nms"]


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [N,4], b: [M,4] xyxy → [N,M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * \
        (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * \
        (b[:, 3] - b[:, 1]).clamp(min=0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-10)


def iou(boxes1: torch.Tensor, boxes2: torch.Tensor, name=None
        ) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes ``[N, 4]`` and ``[M, 4]``: ``[N, M]``."""
    return _pairwise_iou(torch.as_tensor(boxes1), torch.as_tensor(boxes2))


def yolo_box(x: torch.Tensor, img_size: torch.Tensor, anchors: Sequence,
             class_num: int, conf_thresh: float, downsample_ratio: int,
             clip_bbox: bool = True, scale_x_y: float = 1.0,
             iou_aware: bool = False, iou_aware_factor: float = 0.5,
             name=None):
    """Decode one YOLO head ``x: [B, na*(5+C), H, W]`` (``na*(6+C)``
    channels with ``iou_aware``) into ``(boxes [B, na*H*W, 4], scores
    [B, na*H*W, C])``: box centres ``(s * sigmoid(t) - (s - 1) / 2 +
    cell) / grid``, sizes ``exp(t) * anchor / (grid * downsample_ratio)``,
    scaled to ``img_size`` (``[B, 2]``, height then width) as xyxy and
    clipped to the image; scores ``objectness * sigmoid(class)``, zero
    where the objectness is at most ``conf_thresh``. A channels-last head
    is read through one copy (the reshape)."""
    anchors = torch.as_tensor(np.asarray(anchors, np.float32).reshape(-1, 2),
                              device=x.device)
    na = anchors.shape[0]
    b, _, h, w = x.shape
    pred = x.reshape(b, na, 5 + class_num + (1 if iou_aware else 0), h, w)
    if iou_aware:
        ioup = torch.sigmoid(pred[:, :, -1])
        pred = pred[:, :, :-1]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[
        None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[
        None, None, :, None]
    sx = torch.sigmoid(pred[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
    sy = torch.sigmoid(pred[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
    cx = (sx + gx) / w
    cy = (sy + gy) / h
    aw = anchors[:, 0][None, :, None, None]
    ah = anchors[:, 1][None, :, None, None]
    bw = torch.exp(pred[:, :, 2]) * aw / (w * downsample_ratio)
    bh = torch.exp(pred[:, :, 3]) * ah / (h * downsample_ratio)
    obj = torch.sigmoid(pred[:, :, 4])
    if iou_aware:
        obj = obj ** (1 - iou_aware_factor) * ioup ** iou_aware_factor
    cls = torch.sigmoid(pred[:, :, 5:])                 # [B,na,C,H,W]
    scores = torch.where(obj[:, :, None] > conf_thresh,
                         obj[:, :, None] * cls, torch.zeros((), device=x.device,
                                                            dtype=cls.dtype))
    img_size = torch.as_tensor(img_size, device=x.device)
    imh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x0 = (cx - bw / 2) * imw
    y0 = (cy - bh / 2) * imh
    x1 = (cx + bw / 2) * imw
    y1 = (cy + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), device=x.device)
        x0 = torch.clamp(x0, zero, imw - 1)
        y0 = torch.clamp(y0, zero, imh - 1)
        x1 = torch.clamp(x1, zero, imw - 1)
        y1 = torch.clamp(y1, zero, imh - 1)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1)       # [B,na,H,W,4]
    boxes = boxes.reshape(b, na * h * w, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(b, na * h * w, class_num)
    return boxes, scores


def _iou_matrix_np(b):
    """Pairwise IoU on host (numpy twin of _pairwise_iou)."""
    area = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    x0 = np.maximum(b[:, None, 0], b[None, :, 0])
    y0 = np.maximum(b[:, None, 1], b[None, :, 1])
    x1 = np.minimum(b[:, None, 2], b[None, :, 2])
    y1 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    union = area[:, None] + area[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def _nms_keep_np(boxes, scores, iou_threshold):
    """Greedy hard-NMS on host; returns keep mask [N]."""
    n = boxes.shape[0]
    order = np.argsort(-scores)
    ious = _iou_matrix_np(boxes[order])
    keep_sorted = np.ones(n, bool)
    rng = np.arange(n)
    for i in range(n):
        if keep_sorted[i]:
            keep_sorted &= ~((ious[i] > iou_threshold) & (rng > i))
    keep = np.zeros(n, bool)
    keep[order] = keep_sorted
    return keep


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _like(arr: np.ndarray, ref) -> torch.Tensor:
    """``arr`` as a tensor on ``ref``'s device (the CPU for host data)."""
    out = torch.from_numpy(arr)
    return out.to(ref.device) if isinstance(ref, torch.Tensor) else out


def nms(boxes, iou_threshold: float = 0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None) -> torch.Tensor:
    """Hard NMS (Paddle's ``vision.ops.nms``), on the host: the kept box
    indices (int64) sorted by score, at most ``top_k``. Without
    ``scores``, earlier boxes rank higher; with ``category_idxs``, boxes
    suppress only boxes of their own category."""
    bn = _host(boxes)
    sn = _host(scores) if scores is not None else \
        np.arange(bn.shape[0], 0, -1).astype(np.float32)
    if category_idxs is not None:
        c = _host(category_idxs).astype(np.float32)
        span = bn.max() - bn.min() + 1.0
        bn = bn + c[:, None] * span
    keep_np = _nms_keep_np(bn, sn, iou_threshold)
    idx = np.nonzero(keep_np)[0]
    idx = idx[np.argsort(-sn[idx])]
    if top_k is not None:
        idx = idx[:top_k]
    return _like(idx.astype(np.int64), boxes)


def multiclass_nms(bboxes, scores, score_threshold: float = 0.05,
                   nms_top_k: int = 400, keep_top_k: int = 100,
                   nms_threshold: float = 0.45, normalized: bool = True,
                   background_label: int = -1, name=None) -> torch.Tensor:
    """Per-class NMS then a global top-k for one image, on the host:
    ``bboxes [N, 4]``, ``scores [C, N]`` (tensors or numpy arrays) →
    ``[M, 6]`` f32 rows ``(label, score, x0, y0, x1, y1)`` by falling
    score, on ``bboxes``'s device (the CPU for numpy input)."""
    b = _host(bboxes)
    s = _host(scores)
    out = []
    for c in range(s.shape[0]):
        if c == background_label:
            continue
        cs = s[c]
        sel = cs > score_threshold
        if not sel.any():
            continue
        idx = np.nonzero(sel)[0]
        idx = idx[np.argsort(-cs[idx])][:nms_top_k]
        keep_mask = _nms_keep_np(b[idx], cs[idx], nms_threshold)
        keep_rel = np.nonzero(keep_mask)[0]
        keep_rel = keep_rel[np.argsort(-cs[idx][keep_rel])]
        for i in keep_rel:
            gi = idx[i]
            out.append([float(c), float(cs[gi])] + b[gi].tolist())
    if not out:
        return _like(np.zeros((0, 6), np.float32), bboxes)
    out = np.asarray(out, np.float32)
    out = out[np.argsort(-out[:, 1])][:keep_top_k]
    return _like(out, bboxes)
