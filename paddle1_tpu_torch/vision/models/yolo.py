"""YOLOv3 for inference (port of ``paddle1_tpu/vision/models/yolo.py``):
the DarkNet-53 backbone, the FPN-style neck and the three heads, with the
same attribute paths, so state names match the JAX package's
(``backbone.stage3.1.conv2.bn._mean``, ``block4.body.0.conv.weight``,
``head5.bias``, ...) and ``convert.state_from_jax`` loads its
``functional_state()`` unchanged.

Every layer takes ``device`` (default: the current place, the card until
``set_device``) and ``generator`` (for seeded weights), keyword-only.
Under ``conv_nhwc`` (``auto``: CUDA) the activations carry channels-last
memory from the stem convolution on:
``F.interpolate`` and ``ops.concat`` hand it on, so each of the 72 batch
norms runs its kernel on a free ``[rows, C]`` view, and ``YOLOv3`` keeps
its conv weights in channels-last memory too (``channels_last_weights``).
In eval mode every batch norm is the given-statistics kernel
(``fused_bn_norm``) followed by a separate leaky ReLU, as in the
reference (the kernel's activation is identity or relu).

:meth:`YOLOv3.postprocess` decodes the heads with ``vision.ops.yolo_box``
where they lie, copies the decoded boxes and scores to the host once, and
runs ``multiclass_nms`` there in numpy, image by image.

:func:`yolov3_loss` is the training loss, the JAX package's vectorized
form of the reference's ``yolov3_loss_op`` in torch ops with autograd:
the targets are built for every ground-truth box at once by scatters (no
host loop over boxes), and the gradient reaches the head outputs only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.errors import UnimplementedError
from ...nn import functional as F
from ...nn.functional._layout import channels_last_weights
from ...nn.layer_base import Layer
from ...nn.layer_conv_pool import Conv2D
from ...nn.layer_norm_act import BatchNorm2D, LeakyReLU, Sequential
from ...ops import manip_ops
from .. import ops as V

__all__ = ["ConvBNLeaky", "DarkBlock", "DarkNet53", "YoloDetBlock",
           "YOLOv3", "yolov3", "yolov3_loss"]

_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
            156, 198, 373, 326]
_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


class ConvBNLeaky(Layer):
    """A ``k x k`` convolution without bias, a batch norm and a leaky ReLU
    of slope 0.1."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=k // 2,
                           bias_attr=False, device=device,
                           generator=generator)
        self.bn = BatchNorm2D(cout, device=device)
        self.act = LeakyReLU(0.1)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class DarkBlock(Layer):
    """The residual block: ``x + conv3x3(conv1x1(x))`` at half width
    inside."""

    def __init__(self, ch: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBNLeaky(ch, ch // 2, 1, **kw)
        self.conv2 = ConvBNLeaky(ch // 2, ch, 3, **kw)

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class DarkNet53(Layer):
    """The backbone, emitting C3/C4/C5 (strides 8, 16, 32); ``depths`` are
    the DarkBlocks of its five stages."""

    def __init__(self, depths=(1, 2, 8, 8, 4), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stem = ConvBNLeaky(3, 32, 3, **kw)
        chans = [64, 128, 256, 512, 1024]
        stages = []
        cin = 32
        for ch, n in zip(chans, depths):
            blocks = [ConvBNLeaky(cin, ch, 3, stride=2, **kw)]
            blocks += [DarkBlock(ch, **kw) for _ in range(n)]
            stages.append(Sequential(*blocks))
            cin = ch
        self.stage1, self.stage2, self.stage3, self.stage4, self.stage5 = \
            stages

    def forward(self, x):
        x = self.stem(x)
        x = self.stage1(x)
        x = self.stage2(x)
        c3 = self.stage3(x)
        c4 = self.stage4(c3)
        c5 = self.stage5(c4)
        return c3, c4, c5


class YoloDetBlock(Layer):
    """Five alternating 1 x 1 / 3 x 3 ConvBNLeaky (the route) and a 3 x 3
    tip; returns ``(route, tip)``."""

    def __init__(self, cin: int, ch: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.body = Sequential(
            ConvBNLeaky(cin, ch, 1, **kw), ConvBNLeaky(ch, ch * 2, 3, **kw),
            ConvBNLeaky(ch * 2, ch, 1, **kw), ConvBNLeaky(ch, ch * 2, 3, **kw),
            ConvBNLeaky(ch * 2, ch, 1, **kw))
        self.tip = ConvBNLeaky(ch, ch * 2, 3, **kw)

    def forward(self, x):
        route = self.body(x)
        return route, self.tip(route)


class YOLOv3(Layer):
    """YOLOv3 over DarkNet-53 with the COCO anchors: ``forward(x)`` on
    ``[B, 3, H, W]`` returns the three heads ``[p5, p4, p3]``, each
    ``[B, 3 * (5 + num_classes), H / s, W / s]`` for strides 32, 16, 8."""

    def __init__(self, num_classes: int = 80, anchors=None,
                 anchor_masks=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.anchors = anchors or _ANCHORS
        self.anchor_masks = anchor_masks or _MASKS
        self.backbone = DarkNet53(**kw)
        out_ch = 3 * (5 + num_classes)
        self.block5 = YoloDetBlock(1024, 512, **kw)
        self.block4 = YoloDetBlock(512 + 256, 256, **kw)
        self.block3 = YoloDetBlock(256 + 128, 128, **kw)
        self.route5 = ConvBNLeaky(512, 256, 1, **kw)
        self.route4 = ConvBNLeaky(256, 128, 1, **kw)
        self.head5 = Conv2D(1024, out_ch, 1, **kw)
        self.head4 = Conv2D(512, out_ch, 1, **kw)
        self.head3 = Conv2D(256, out_ch, 1, **kw)
        channels_last_weights(self)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        r5, t5 = self.block5(c5)
        p5 = self.head5(t5)
        u5 = F.interpolate(self.route5(r5), scale_factor=2, mode="nearest")
        r4, t4 = self.block4(manip_ops.concat([u5, c4], axis=1))
        p4 = self.head4(t4)
        u4 = F.interpolate(self.route4(r4), scale_factor=2, mode="nearest")
        r3, t3 = self.block3(manip_ops.concat([u4, c3], axis=1))
        p3 = self.head3(t3)
        return [p5, p4, p3]     # strides 32, 16, 8

    @torch.no_grad()
    def postprocess(self, outputs, img_size, conf_thresh: float = 0.01,
                    nms_thresh: float = 0.45, keep_top_k: int = 100):
        """Decode and suppress one batch: ``yolo_box`` on each head where
        it lies, one copy of the decoded boxes and scores to the host,
        then ``multiclass_nms`` per image in numpy (``img_size``: ``[B,
        2]`` heights and widths). Returns one ``[M, 6]`` CPU tensor of
        ``(label, score, x0, y0, x1, y1)`` rows per image."""
        img_size = torch.as_tensor(img_size, device=outputs[0].device)
        all_boxes, all_scores = [], []
        for out, mask, stride in zip(outputs, self.anchor_masks,
                                     (32, 16, 8)):
            sub_anchors = []
            for m in mask:
                sub_anchors += self.anchors[2 * m:2 * m + 2]
            b, s = V.yolo_box(out, img_size, sub_anchors, self.num_classes,
                              conf_thresh, stride)
            all_boxes.append(b)
            all_scores.append(s)
        decoded = manip_ops.concat(
            [manip_ops.concat(all_boxes, axis=1),
             manip_ops.concat(all_scores, axis=1)], axis=2).cpu().numpy()
        return [V.multiclass_nms(d[:, :4], d[:, 4:].T,
                                 score_threshold=conf_thresh,
                                 nms_threshold=nms_thresh,
                                 keep_top_k=keep_top_k)
                for d in decoded]


def yolov3(pretrained: bool = False, num_classes: int = 80, **kwargs):
    if pretrained:
        raise UnimplementedError(
            "pretrained weights are not bundled; load a checkpoint with "
            "load_state_dict (convert.state_from_jax for the JAX "
            "package's)")
    return YOLOv3(num_classes=num_classes, **kwargs)


def _bce(logit, target, weight):
    """Weighted binary cross-entropy with logits, summed, in the JAX
    package's form ``max(z, 0) - z t + log1p(exp(-|z|))``."""
    return torch.sum(weight * (torch.clamp(logit, min=0) - logit * target +
                               torch.log1p(torch.exp(-logit.abs()))))


def _as_f32(v, device):
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _level_loss(pred, gtb, gtl, gts, valid, mask, ds, anchors, num_classes,
                ignore_thresh, label_pos, label_neg, sxy):
    """One head's loss (``yolo.py:200-324`` of the JAX package)."""
    dev = pred.device
    na = len(mask)
    b, _, h, w = pred.shape
    pred = pred.float().reshape(b, na, 5 + num_classes, h, w)
    tx, ty, tw, th = pred[:, :, 0], pred[:, :, 1], pred[:, :, 2], \
        pred[:, :, 3]
    tobj, tcls = pred[:, :, 4], pred[:, :, 5:]
    sub = anchors[mask]                                   # [na, 2]
    with torch.no_grad():
        gx, gy = gtb[:, :, 0] * w, gtb[:, :, 1] * h      # [B, G]
        gw, gh = gtb[:, :, 2], gtb[:, :, 3]
        ci = gx.to(torch.int64).clamp(0, w - 1)
        cj = gy.to(torch.int64).clamp(0, h - 1)
        # best anchor per box by wh-IoU against ALL anchors; the boxes
        # whose best is one of this level's
        gwh = torch.stack([gw * (w * ds), gh * (h * ds)], -1)[..., None, :]
        inter = torch.minimum(gwh, anchors[None, None]).prod(-1)
        union = gwh.prod(-1) + anchors.prod(-1)[None, None] - inter
        best = torch.argmax(inter / union.clamp(min=1e-10), dim=-1)
        mask_t = torch.as_tensor(mask, device=dev)
        sel = valid[..., None] & (best[..., None] == mask_t)  # [B, G, na]
        # ignore_thresh: the best IoU of each decoded box against any box
        gxn = torch.arange(w, dtype=torch.float32, device=dev)
        gyn = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        sx = sxy * torch.sigmoid(tx) - 0.5 * (sxy - 1.0)
        sy = sxy * torch.sigmoid(ty) - 0.5 * (sxy - 1.0)
        pcx, pcy = (sx + gxn) / w, (sy + gyn) / h
        pw_ = torch.exp(tw.clamp(-10, 10)) * sub[:, 0, None, None] / (w * ds)
        ph_ = torch.exp(th.clamp(-10, 10)) * sub[:, 1, None, None] / (h * ds)
        pb = torch.stack([pcx - pw_ / 2, pcy - ph_ / 2, pcx + pw_ / 2,
                          pcy + ph_ / 2], -1).reshape(b, -1, 4)
        gt_xyxy = torch.stack([gtb[:, :, 0] - gw / 2, gtb[:, :, 1] - gh / 2,
                               gtb[:, :, 0] + gw / 2, gtb[:, :, 1] + gh / 2],
                              -1)
        lt = torch.maximum(pb[:, :, None, :2], gt_xyxy[:, None, :, :2])
        rb = torch.minimum(pb[:, :, None, 2:], gt_xyxy[:, None, :, 2:])
        whi = (rb - lt).clamp(min=0)
        inter_p = whi[..., 0] * whi[..., 1]
        area_p = ((pb[:, :, 2] - pb[:, :, 0]) *
                  (pb[:, :, 3] - pb[:, :, 1]))[:, :, None]
        iou = inter_p / (area_p + (gw * gh)[:, None, :] -
                         inter_p).clamp(min=1e-10)
        iou = torch.where(valid[:, None, :], iou, torch.zeros_like(iou))
        best_iou = iou.amax(dim=2).reshape(b, na, h, w) if iou.shape[2] \
            else torch.zeros(b, na, h, w, device=dev)

        # dense targets: every (image, box, anchor) writes its cell, the
        # unselected ones with weight 0 (.max of 0 and .add of 0 change
        # nothing, as in the JAX package's scatters)
        cells = b * na * h * w
        cell = ((torch.arange(b, device=dev)[:, None, None] * na +
                 torch.arange(na, device=dev)[None, None, :]) * h +
                cj[..., None]) * w + ci[..., None]         # [B, G, na]
        cell = cell.reshape(-1)
        selw = sel.float()
        selws = selw * gts[..., None]
        zeros = torch.zeros(cells, device=dev)

        def put_max(v):
            return zeros.scatter_reduce(0, cell, v.reshape(-1), "amax")

        def put_add(v):
            return zeros.index_add(0, cell, v.reshape(-1))
        obj_t = put_max(selw)
        fx = ((gx - torch.floor(gx) + 0.5 * (sxy - 1.0)) / sxy).clamp(0, 1)
        fy = ((gy - torch.floor(gy) + 0.5 * (sxy - 1.0)) / sxy).clamp(0, 1)
        txt = put_add(selw * fx[..., None])
        tyt = put_add(selw * fy[..., None])
        twt = put_add(selw * torch.log(
            (gw[..., None] * w * ds / sub[:, 0]).clamp(min=1e-9)))
        tht = put_add(selw * torch.log(
            (gh[..., None] * h * ds / sub[:, 1]).clamp(min=1e-9)))
        box_w = put_max(selws)
        onehot = torch.nn.functional.one_hot(gtl.clamp(min=0),
                                             num_classes).float()
        smooth = onehot * label_pos + (1.0 - onehot) * label_neg
        # cls target [B, na, C, H, W]: cell (b, a, j, i) -> b, a, c, j, i
        hw = h * w
        ccell = ((cell // hw)[:, None] * num_classes +
                 torch.arange(num_classes, device=dev)) * hw + \
            (cell % hw)[:, None]
        cls_v = selw[..., None] * smooth[:, :, None, :]   # [B, G, na, C]
        cls_t = torch.zeros(cells * num_classes, device=dev).scatter_reduce(
            0, ccell.reshape(-1), cls_v.reshape(-1), "amax")
        shape = (b, na, h, w)
        obj_t, txt, tyt, twt, tht, box_w = (
            t.reshape(shape) for t in (obj_t, txt, tyt, twt, tht, box_w))
        cls_t = cls_t.reshape(b, na, num_classes, h, w)
        obj_w = torch.where(obj_t > 0, box_w.clamp(min=1e-8),
                            (best_iou < ignore_thresh).float())
    loss_xy = _bce(tx, txt, box_w) + _bce(ty, tyt, box_w)
    loss_wh = torch.sum(box_w * ((tw - twt) ** 2 + (th - tht) ** 2)) * 0.5
    loss_obj = _bce(tobj, obj_t, obj_w)
    loss_cls = _bce(tcls, cls_t, box_w[:, :, None].expand_as(cls_t))
    return loss_xy + loss_wh + loss_obj + loss_cls


def yolov3_loss(outputs, gt_boxes, gt_labels, anchors=None,
                anchor_masks=None, num_classes=80, ignore_thresh=0.7,
                downsample_ratios=(32, 16, 8), gt_scores=None,
                use_label_smooth=False, scale_x_y=1.0):
    """YOLOv3 training loss (the reference's ``yolov3_loss_op``, as the
    JAX package vectorizes it, ``yolo.py:181``).

    ``outputs``: the heads ``[B, na * (5 + C), H, W]`` in the order of
    ``anchor_masks`` and ``downsample_ratios``; ``gt_boxes``: ``[B, G,
    4]`` centre-size boxes normalized to [0, 1]; ``gt_labels``: ``[B,
    G]`` ints, -1 (or a zero width) for padding; ``gt_scores``: ``[B,
    G]`` weights of each box's terms (mixup), default ones;
    ``use_label_smooth``: class targets ``1 - s`` and ``s`` with ``s =
    min(1 / C, 1 / 40)``; ``scale_x_y``: centres decoded as ``s *
    sigmoid(t) - (s - 1) / 2``. Each box goes to the cell holding its
    centre and its best anchor by wh-IoU over all anchors, on the level
    whose mask holds that anchor; a cell that is not positive is a
    negative only where no decoded box of it overlaps a box by
    ``ignore_thresh`` or more. Returns the sum of the xy, wh, objectness
    and class terms over the levels, over the batch size (a 0-d f32
    tensor). The heads are read in f32 whatever their dtype; the targets
    are built without gradient."""
    dev = outputs[0].device
    anchors = torch.as_tensor(np.asarray(anchors or _ANCHORS, np.float32)
                              .reshape(-1, 2), device=dev)
    anchor_masks = anchor_masks or _MASKS
    if use_label_smooth:
        sw = min(1.0 / num_classes, 1.0 / 40)
        label_pos, label_neg = 1.0 - sw, sw
    else:
        label_pos, label_neg = 1.0, 0.0
    gtb = _as_f32(gt_boxes, dev)
    if isinstance(gt_labels, torch.Tensor):
        gtl = gt_labels.detach().to(device=dev, dtype=torch.int64)
    else:
        gtl = torch.as_tensor(np.asarray(gt_labels, np.int64), device=dev)
    gts = torch.ones(gtl.shape, device=dev) if gt_scores is None else \
        _as_f32(gt_scores, dev)
    valid = (gtl >= 0) & (gtb[:, :, 2] > 0)
    total = 0.0
    for pred, mask, ds in zip(outputs, anchor_masks, downsample_ratios):
        total = total + _level_loss(
            pred, gtb, gtl, gts, valid, list(mask), ds, anchors,
            num_classes, ignore_thresh, label_pos, label_neg,
            float(scale_x_y))
    return total / outputs[0].shape[0]
