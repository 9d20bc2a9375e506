"""Detection ops (port of ``paddle1_tpu/vision/ops.py``: every name but
``read_file`` and ``decode_jpeg``, which wait for ``core/jpeg.py``).

``yolo_box``, ``box_coder``, ``roi_align``/``roi_pool``,
``deform_conv2d`` and ``yolo_loss`` are tensor code and run where their
input lies (the card, on the ported paths), with autograd; ``prior_box``,
``generate_anchors`` and ``distribute_fpn_proposals`` compute their small
tables in numpy, as the JAX package does, and ``matrix_nms`` decays its
scores on the device and sorts on the host.

Host data (numpy, lists) given to these ops goes to the current place,
as ``to_tensor`` puts it, and their results of host data are returned
there; an op's other inputs follow its first tensor. ``nms`` and
``multiclass_nms`` alone return host data's result on the CPU: they run
on the host, and ``YOLOv3.postprocess`` hands them its one host copy.

The non-maximum suppressions run on the host in numpy, as the
reference's eager arms do: greedy NMS is a loop of small dependent
steps, so each image's boxes are copied to the host once and every class
is suppressed there, with no per-class device round trip.
The numpy helpers are the reference's, line for line, so identical
inputs give identical kept sets (greedy NMS can reorder under a 1e-6
change near a tie or the threshold).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.tensor import to_tensor
from ..nn.layer_base import Layer

__all__ = ["iou", "box_coder", "yolo_box", "nms", "multiclass_nms",
           "matrix_nms", "roi_align", "roi_pool", "prior_box",
           "generate_anchors", "distribute_fpn_proposals", "deform_conv2d",
           "DeformConv2D", "yolo_loss", "read_file", "decode_jpeg"]


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


def _tensor(v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``v`` as a tensor: a tensor as it is; host data as
    :func:`to_tensor` makes it, on ``like``'s device, else on the current
    place (the module docstring's rule)."""
    if isinstance(v, torch.Tensor):
        return v
    if like is None:
        return to_tensor(v)
    return to_tensor(v, place="cpu").to(like.device)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode boxes against priors or decode offsets (the reference's
    ``box_coder_op``): ``prior_box`` ``[M, 4]`` xyxy; encoding gives
    every target ``[N, 4]`` against every prior, ``[N, M, 4]``; decoding
    takes ``[N, M, 4]`` offsets (``axis`` names the target axis the
    priors run along: 0 → dim 1, 1 → dim 0) or ``[..., 4]``. A
    ``[M, 4]`` or ``[4]`` variance divides (encode) or scales (decode)
    the offsets. Unnormalized boxes count their end pixel (``+ 1``)."""
    prior = _tensor(prior_box)
    target = _tensor(target_box, prior)
    var = None if prior_box_var is None else _tensor(prior_box_var, prior)
    n1 = 0.0 if box_normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + n1
    ph = prior[:, 3] - prior[:, 1] + n1
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0] + n1
        th = target[:, 3] - target[:, 1] + n1
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        out = torch.stack(
            [(tcx[:, None] - pcx[None, :]) / pw[None, :],
             (tcy[:, None] - pcy[None, :]) / ph[None, :],
             torch.log(tw[:, None] / pw[None, :]),
             torch.log(th[:, None] / ph[None, :])], dim=2)
        if var is not None:
            out = out / (var[None, :, :] if var.dim() == 2 else
                         var.reshape(1, 1, 4))
        return out
    if target.dim() == 3:
        exp = (lambda a: a[None, :]) if axis == 0 else (lambda a: a[:, None])
    else:
        exp = lambda a: a   # noqa: E731
    t = target
    if var is not None:
        if var.dim() == 2:
            vb = (var[None, :, :] if axis == 0 else var[:, None, :]) \
                if target.dim() == 3 else var
        else:
            vb = var.reshape((1,) * (target.dim() - 1) + (4,))
        t = target * vb
    cx = t[..., 0] * exp(pw) + exp(pcx)
    cy = t[..., 1] * exp(ph) + exp(pcy)
    w = torch.exp(t[..., 2]) * exp(pw)
    h = torch.exp(t[..., 3]) * exp(ph)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0,
               nms_top_k=400, keep_top_k=100, use_gaussian=False,
               gaussian_sigma=2.0, background_label=-1, normalized=True,
               name=None):
    """Matrix NMS (the reference's ``matrix_nms_op``, SOLOv2): every
    score decays by its overlaps with higher-scoring boxes of its class,
    in parallel, no sequential suppression. One image: ``bboxes [N,
    4]``, ``scores [C, N]`` → ``[M, 6]`` f32 rows ``(label, score, x0,
    y0, x1, y1)`` by falling decayed score, on ``bboxes``'s device. As in
    the JAX package, the ``nms_top_k`` candidates are taken over all
    classes together and ``background_label`` is not read. Ties keep the
    lower flat index first (a stable sort)."""
    boxes = _tensor(bboxes)
    sc = _tensor(scores, boxes)
    c, n = sc.shape
    flat = sc.reshape(-1)
    k = min(nms_top_k, flat.shape[0])
    top_scores, top_idx = torch.sort(flat, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    cls = top_idx // n
    bx = boxes[top_idx % n]
    ious = _pairwise_iou(bx, bx)
    lower = torch.tril(torch.ones(k, k, dtype=torch.bool,
                                  device=boxes.device), -1)
    pair = (cls[:, None] == cls[None, :]) & lower     # j < i, same class
    zero = torch.zeros_like(ious)
    max_iou = torch.where(pair, ious, zero).amax(dim=1) if k else \
        top_scores
    one = torch.ones_like(ious)
    if use_gaussian:
        comp = torch.exp(-(ious ** 2 - max_iou[None, :] ** 2) /
                         gaussian_sigma)
    else:
        comp = (1 - ious) / (1 - max_iou[None, :]).clamp(min=1e-10)
    decay = torch.where(pair, comp, one).amin(dim=1) if k else top_scores
    dec = top_scores * decay
    valid = (top_scores > score_threshold) & (dec > post_threshold)
    dec = torch.where(valid, dec, torch.full_like(dec, -1.0))
    d = _host(dec)
    order = np.argsort(-d, kind="stable")[:keep_top_k]
    order = order[d[order] > 0]
    rows = np.concatenate([_host(cls)[order, None].astype(np.float32),
                           d[order, None], _host(bx)[order]], axis=1)
    return _like(rows.astype(np.float32), boxes)


def _bilinear_rois(feat, img_of_roi, ys, xs):
    """Bilinear samples of ``feat [B, C, H, W]``: roi ``r`` at rows
    ``ys[r]`` and columns ``xs[r]`` of image ``img_of_roi[r]`` →
    ``[R, C, hs, ws]`` (indices clipped to the map, weights to [0, 1],
    as the JAX package's ``roi_align``)."""
    _, _, hgt, wid = feat.shape
    y0 = torch.floor(ys).to(torch.int64).clamp(0, hgt - 1)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, wid - 1)
    y1, x1 = (y0 + 1).clamp(0, hgt - 1), (x0 + 1).clamp(0, wid - 1)
    wy = (ys - y0).clamp(0, 1)[:, None, :, None]
    wx = (xs - x0).clamp(0, 1)[:, None, None, :]
    img = img_of_roi[:, None, None]

    def at(yi, xi):      # [R, hs, ws, C] -> [R, C, hs, ws]
        return feat[img, :, yi[:, :, None], xi[:, None, :]].permute(
            0, 3, 1, 2)
    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def roi_align(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None, _reduce="mean"):
    """RoIAlign (the reference's ``roi_align_op``): ``x [B, C, H, W]``,
    ``boxes [R, 4]`` xyxy in input coordinates, ``boxes_num`` the RoIs
    of each image (all of image 0 without it) → ``[R, C, oh, ow]``, the
    mean of ``sampling_ratio`` x ``sampling_ratio`` bilinear samples a
    bin (2 where it is not positive; ``aligned`` shifts by half a
    pixel). Vectorized over the RoIs; gradients reach ``x`` and
    ``boxes``."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    feat = _tensor(x)
    rois = _tensor(boxes, feat)
    r = rois.shape[0]
    if boxes_num is None:
        img_of_roi = torch.zeros(r, dtype=torch.int64, device=feat.device)
    else:
        nums = _host(boxes_num).astype(np.int64).reshape(-1)
        img_of_roi = torch.as_tensor(np.repeat(np.arange(len(nums)), nums),
                                     device=feat.device)
    sr = sampling_ratio if sampling_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    x0 = rois[:, 0] * spatial_scale - off
    y0 = rois[:, 1] * spatial_scale - off
    rw = (rois[:, 2] * spatial_scale - off - x0).clamp(min=1e-3)
    rh = (rois[:, 3] * spatial_scale - off - y0).clamp(min=1e-3)
    dt = feat.dtype
    py = (torch.arange(oh * sr, dtype=dt, device=feat.device) + 0.5) / \
        (oh * sr)
    px = (torch.arange(ow * sr, dtype=dt, device=feat.device) + 0.5) / \
        (ow * sr)
    sy = y0[:, None] + rh[:, None] * py[None, :]
    sx = x0[:, None] + rw[:, None] * px[None, :]
    samp = _bilinear_rois(feat, img_of_roi, sy, sx)
    samp = samp.reshape(r, feat.shape[1], oh, sr, ow, sr)
    if _reduce == "max":
        return samp.amax(dim=(3, 5))
    return samp.mean(dim=(3, 5))


def roi_pool(x, boxes, boxes_num=None, output_size=7, spatial_scale=1.0,
             name=None):
    """Max RoI pooling (the reference's ``roi_pool_op``) as the JAX
    package computes it: ``roi_align``'s bilinear grid (2 x 2 samples a
    bin, not aligned) with a max over each bin, in place of the legacy
    integer bins."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    return roi_align(x, boxes, boxes_num, output_size, spatial_scale,
                     sampling_ratio=2, aligned=False, _reduce="max")


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """SSD prior boxes of one feature map (the reference's
    ``prior_box_op``): ``(boxes [H, W, P, 4], variances [H, W, P, 4])``
    normalized xyxy, on ``input``'s device."""
    inp, img = _tensor(input), _tensor(image)
    fh, fw = int(inp.shape[2]), int(inp.shape[3])
    ih, iw = int(img.shape[2]), int(img.shape[3])
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    sizes = []
    for ms in min_sizes:
        sizes.append((ms, ms))
        for xs in (max_sizes or ()):
            sizes.append((float(np.sqrt(ms * xs)),) * 2)
        sizes += [(ms * np.sqrt(a), ms / np.sqrt(a)) for a in ars
                  if a != 1.0]
    wh = np.asarray(sizes, np.float32)
    cxg, cyg = np.meshgrid((np.arange(fw) + offset) * step_w,
                           (np.arange(fh) + offset) * step_h)
    out = np.zeros((fh, fw, len(sizes), 4), np.float32)
    out[..., 0] = (cxg[..., None] - wh[None, None, :, 0] / 2) / iw
    out[..., 1] = (cyg[..., None] - wh[None, None, :, 1] / 2) / ih
    out[..., 2] = (cxg[..., None] + wh[None, None, :, 0] / 2) / iw
    out[..., 3] = (cyg[..., None] + wh[None, None, :, 1] / 2) / ih
    if clip:
        out = np.clip(out, 0, 1)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape).copy()
    return _like(out, inp), _like(var, inp)


def generate_anchors(stride, sizes=(32,), aspect_ratios=(0.5, 1.0, 2.0)):
    """The base anchors of one FPN level (``anchor_generator_op``'s
    analog): ``[len(sizes) * len(aspect_ratios), 4]`` xyxy around 0, on
    the current place."""
    anchors = []
    for s in sizes:
        area = float(s) ** 2
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = w * ar
            anchors.append([-w / 2, -h / 2, w / 2, h / 2])
    return torch.from_numpy(np.asarray(anchors, np.float32)).to(
        resolve_device(None))


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """Assign RoIs to FPN levels by scale (the reference's
    ``distribute_fpn_proposals_op``): level ``floor(log2(sqrt(wh) /
    refer_scale + 1e-8)) + refer_level`` clipped to ``[min_level,
    max_level]``. Returns (the RoIs of each level, the int64 index that
    restores the original order from their concatenation), on
    ``fpn_rois``'s device (the current place for host data)."""
    rois = _host(fpn_rois)
    dev = fpn_rois.device if isinstance(fpn_rois, torch.Tensor) else \
        resolve_device(None)
    w = np.maximum(rois[:, 2] - rois[:, 0], 0)
    h = np.maximum(rois[:, 3] - rois[:, 1], 0)
    lvl = np.floor(np.log2(np.sqrt(w * h) / refer_scale + 1e-8)) + \
        refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    outs, order = [], []
    for level in range(min_level, max_level + 1):
        idx = np.nonzero(lvl == level)[0]
        order.append(idx)
        outs.append(torch.from_numpy(np.ascontiguousarray(rois[idx]))
                    .to(dev))
    order = np.concatenate(order) if order else np.zeros(0, np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    return outs, torch.from_numpy(restore.astype(np.int64)).to(dev)


def deform_conv2d_core(x, off, msk, weight, bias, stride, padding,
                       dilation, groups, dg):
    """The deformable convolution with explicit ``weight [F, C/groups, kh,
    kw]`` and ``bias`` (the port's copy of the JAX package's
    ``fluid/detection_train.py:547``): every tap of every output position
    samples ``x`` bilinearly at its offset position (offsets ``[N, dg *
    kh * kw * 2, Ho, Wo]``, y then x a tap; a corner outside the map
    reads 0), scaled by ``msk`` (v2) when given, and one grouped
    contraction with the weight makes the output."""
    sh, sw = stride
    ph_, pw_ = padding
    dh, dw = dilation
    nf, _, kh, kw = weight.shape
    n, c, hgt, wid = x.shape
    ho = (hgt + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    wo = (wid + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    dev, dt = x.device, x.dtype
    ys = torch.arange(ho, device=dev, dtype=dt) * sh - ph_
    xs = torch.arange(wo, device=dev, dtype=dt) * sw - pw_
    ky = torch.arange(kh, device=dev, dtype=dt) * dh
    kx = torch.arange(kw, device=dev, dtype=dt) * dw
    # [kh, kw, Ho, Wo] base positions of each tap
    base_y = (ky[:, None, None, None] + ys[None, None, :, None]).expand(
        kh, kw, ho, wo)
    base_x = (kx[None, :, None, None] + xs[None, None, None, :]).expand(
        kh, kw, ho, wo)
    o = off.reshape(n, dg, kh, kw, 2, ho, wo)
    py = base_y + o[:, :, :, :, 0]
    px = base_x + o[:, :, :, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    flat = x.reshape(n, dg, c // dg, hgt * wid)

    def gather(yi, xi):
        yc = yi.clamp(0, hgt - 1).to(torch.int64)
        xc = xi.clamp(0, wid - 1).to(torch.int64)
        idx = (yc * wid + xc).reshape(n, dg, 1, -1).expand(
            n, dg, c // dg, kh * kw * ho * wo)
        got = torch.gather(flat, 3, idx).reshape(n, dg, c // dg, kh, kw,
                                                 ho, wo)
        inb = (yi >= 0) & (yi <= hgt - 1) & (xi >= 0) & (xi <= wid - 1)
        return got * inb[:, :, None].to(dt)
    v = ((1 - wy) * (1 - wx))[:, :, None] * gather(y0, x0) \
        + ((1 - wy) * wx)[:, :, None] * gather(y0, x0 + 1) \
        + (wy * (1 - wx))[:, :, None] * gather(y0 + 1, x0) \
        + (wy * wx)[:, :, None] * gather(y0 + 1, x0 + 1)
    if msk is not None:
        v = v * msk.reshape(n, dg, 1, kh, kw, ho, wo)
    cg = v.reshape(n, groups, c // groups, kh, kw, ho, wo)
    wg = weight.reshape(groups, nf // groups, c // groups, kh, kw)
    out = torch.einsum("ngcklhw,gfckl->ngfhw", cg, wg).reshape(n, nf, ho, wo)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def _two(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution (the reference's ``vision.ops.
    deform_conv2d`` over ``deformable_conv_op``): explicit ``weight [F,
    C/groups, kh, kw]``; with ``mask`` the modulated v2. Plain tensor
    code with autograd, outside any kernel (the JAX package computes it
    with XLA too)."""
    return deform_conv2d_core(x, offset, mask, weight, bias, _two(stride),
                              _two(padding), _two(dilation), groups,
                              deformable_groups)


class DeformConv2D(Layer):
    """The layer form of :func:`deform_conv2d`: owns ``weight`` and
    ``bias`` (the JAX package's ``create_parameter`` defaults); offsets
    and the v2 mask are inputs, computed by a sibling convolution."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = _two(kernel_size)
        dev = dict(device=resolve_device(device), generator=generator)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw], attr=weight_attr,
            **dev)
        self.bias = (self.create_parameter([out_channels], is_bias=True,
                                           attr=bias_attr, **dev)
                     if bias_attr is not False else None)
        self._cfg = (stride, padding, dilation, deformable_groups, groups)

    def forward(self, x, offset, mask=None):
        s, p, d, dg, g = self._cfg
        return deform_conv2d(x, offset, self.weight, self.bias, stride=s,
                             padding=p, dilation=d, deformable_groups=dg,
                             groups=g, mask=mask)


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """One head's YOLOv3 loss (the reference's ``vision.ops.yolo_loss``):
    ``vision.models.yolo.yolov3_loss`` with the one output ``x``. As in
    the JAX package, the loss is reduced over the batch to one value (the
    reference returns one a sample, ``[N]``)."""
    from .models.yolo import yolov3_loss
    return yolov3_loss([x], gt_box, gt_label,
                       anchors=np.asarray(anchors).reshape(-1).tolist(),
                       anchor_masks=[list(anchor_mask)],
                       num_classes=class_num, ignore_thresh=ignore_thresh,
                       downsample_ratios=(downsample_ratio,),
                       gt_scores=gt_score,
                       use_label_smooth=use_label_smooth,
                       scale_x_y=scale_x_y)


def read_file(filename, name=None):
    """The file's bytes as a 1-D uint8 tensor on the current place (the
    JAX package's ``fluid/misc_tail.py:164-174`` for a path; its
    ``PyReader`` branch waits for ROADMAP Queue 1 item 10's readers)."""
    with open(filename, "rb") as f:
        data = f.read()
    return to_tensor(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte tensor to ``[C, H, W]`` uint8 on the current
    place, on the host by the baseline numpy decoder (``core/jpeg.py``,
    sequential DCT as the JAX package decodes). ``mode="gray"`` turns RGB
    into one channel with the JAX package's ``0.299 R + 0.587 G + 0.114
    B``, truncated to uint8."""
    from ..core.jpeg import decode_jpeg_bytes
    data = np.ascontiguousarray(_host(x), np.uint8).tobytes()
    img = decode_jpeg_bytes(data)  # [H, W, C] uint8
    if mode == "gray" and img.shape[-1] == 3:
        img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
               + 0.114 * img[..., 2]).astype(np.uint8)[..., None]
    return to_tensor(np.ascontiguousarray(img.transpose(2, 0, 1)))
