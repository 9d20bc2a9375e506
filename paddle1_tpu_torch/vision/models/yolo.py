"""YOLOv3 for inference (port of ``paddle1_tpu/vision/models/yolo.py``):
the DarkNet-53 backbone, the FPN-style neck and the three heads, with the
same attribute paths, so state names match the JAX package's
(``backbone.stage3.1.conv2.bn._mean``, ``block4.body.0.conv.weight``,
``head5.bias``, ...) and ``convert.state_from_jax`` loads its
``functional_state()`` unchanged.

Every layer takes ``device`` (default: the card) and ``generator`` (for
seeded weights), keyword-only. Under ``conv_nhwc`` (``auto``: CUDA) the
activations carry channels-last memory from the stem convolution on:
``F.interpolate`` and ``ops.concat`` hand it on, so each of the 72 batch
norms runs its kernel on a free ``[rows, C]`` view, and ``YOLOv3`` keeps
its conv weights in channels-last memory too (``channels_last_weights``).
In eval mode every batch norm is the given-statistics kernel
(``fused_bn_norm``) followed by a separate leaky ReLU, as in the
reference (the kernel's activation is identity or relu).

:meth:`YOLOv3.postprocess` decodes the heads with ``vision.ops.yolo_box``
where they lie, copies the decoded boxes and scores to the host once, and
runs ``multiclass_nms`` there in numpy, image by image. ``yolov3_loss``
(training) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

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
           "YOLOv3", "yolov3"]

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
