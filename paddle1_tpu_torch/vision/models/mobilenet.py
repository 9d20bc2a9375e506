"""MobileNetV1 and MobileNetV2 (port of
``paddle1_tpu/vision/models/mobilenet.py``; Howard et al. 2017, Sandler et
al. 2018): the same architecture, API and attribute paths, so state names
match the JAX package's (``features.1.conv.0.conv.weight``,
``features.1.conv.0.bn._mean``, ...).

Every layer takes ``device`` (default: the current place, the card until
``set_device``) and ``generator`` (for seeded weights). The depthwise
convolutions are ``Conv2D(groups=C)`` on cuDNN. Under ``conv_nhwc``
(``auto``: CUDA) the activations carry channels-last memory from the stem
convolution on, so each batch norm runs its kernel on a free ``[rows,
C]`` view and ReLU6 and the residual add keep that memory. The residual
add stays a plain add after the block's last batch norm, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.errors import UnimplementedError
from ...nn.layer_base import Layer
from ...nn.layer_common import Dropout, Linear
from ...nn.layer_conv_pool import AdaptiveAvgPool2D, Conv2D
from ...nn.layer_norm_act import BatchNorm2D, ReLU, ReLU6, Sequential

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class ConvBNLayer(Layer):
    """A bias-free convolution, a ``BatchNorm2D`` and an activation layer
    (``act``, a class; None for none)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, act=ReLU, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv2D(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, groups=groups,
                           bias_attr=False, device=device,
                           generator=generator)
        self.bn = BatchNorm2D(out_channels, device=device)
        self.act = act() if act is not None else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class DepthwiseSeparable(Layer):
    """MobileNetV1's block: a 3 x 3 depthwise ConvBN then a 1 x 1
    pointwise one, widths scaled by ``scale``."""

    def __init__(self, in_channels, out_channels1, out_channels2, stride,
                 scale, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c1 = int(out_channels1 * scale)
        c2 = int(out_channels2 * scale)
        self.depthwise = ConvBNLayer(in_channels, c1, 3, stride=stride,
                                     padding=1, groups=in_channels, **kw)
        self.pointwise = ConvBNLayer(c1, c2, 1, **kw)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool

        def s(c):
            return int(c * scale)
        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1, **kw)
        cfg = [  # in, out1, out2, stride
            (s(32), 32, 64, 1), (s(64), 64, 128, 2), (s(128), 128, 128, 1),
            (s(128), 128, 256, 2), (s(256), 256, 256, 1),
            (s(256), 256, 512, 2)] + [(s(512), 512, 512, 1)] * 5 + [
            (s(512), 512, 1024, 2), (s(1024), 1024, 1024, 1)]
        self.blocks = Sequential(*[
            DepthwiseSeparable(i, o1, o2, st, scale, **kw)
            for i, o1, o2, st in cfg])
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(Layer):
    """MobileNetV2's block: a 1 x 1 expansion by ``expand_ratio`` (none at
    1) with ReLU6, a 3 x 3 depthwise ConvBN with ReLU6, a linear 1 x 1
    projection; the input added back when the stride is 1 and the widths
    agree."""

    def __init__(self, inp, oup, stride, expand_ratio, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1, act=ReLU6, **kw))
        layers += [
            ConvBNLayer(hidden_dim, hidden_dim, 3, stride=stride, padding=1,
                        groups=hidden_dim, act=ReLU6, **kw),
            ConvBNLayer(hidden_dim, oup, 1, act=None, **kw),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res_connect else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        cfg = [  # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        features = [ConvBNLayer(3, input_channel, 3, stride=2, padding=1,
                                act=ReLU6, **kw)]
        for t, c, n, s in cfg:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1, t,
                    **kw))
                input_channel = output_channel
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features.append(ConvBNLayer(input_channel, self.last_channel, 1,
                                    act=ReLU6, **kw))
        self.features = Sequential(*features)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.2), Linear(self.last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _check_pretrained(pretrained):
    if pretrained:
        raise UnimplementedError(
            "pretrained weights are not bundled; load a checkpoint with "
            "load_state_dict (convert.state_from_jax for the JAX "
            "package's)")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _check_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _check_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
