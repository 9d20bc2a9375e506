"""ResNet family (port of ``paddle1_tpu/vision/models/resnet.py``): the
same architecture, API and attribute paths, so state names match the
JAX package's (``layer1.0.conv1.weight``, ``layer1.0.bn1._mean``, ...).

Every layer takes ``device`` (default: the card) and ``generator`` (for
seeded weights). Under ``conv_nhwc`` (``auto``: CUDA) the activations
carry channels-last memory from the stem convolution on, so each
batch norm runs its kernel on a free ``[rows, C]`` view.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...core.errors import UnimplementedError
from ...nn.layer_base import Layer
from ...nn.layer_common import Linear
from ...nn.layer_conv_pool import AdaptiveAvgPool2D, Conv2D, MaxPool2D
from ...nn.layer_norm_act import BatchNorm2D, ReLU, Sequential

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(BatchNorm2D,
                                                     device=device)
        conv = functools.partial(Conv2D, bias_attr=False, device=device,
                                 generator=generator)
        self.conv1 = conv(inplanes, planes, 3, stride=stride, padding=1)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = conv(planes, planes, 3, padding=1)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 device=None, generator=None):
        super().__init__()
        norm_layer = norm_layer or functools.partial(BatchNorm2D,
                                                     device=device)
        conv = functools.partial(Conv2D, bias_attr=False, device=device,
                                 generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(inplanes, width, 1)
        self.bn1 = norm_layer(width)
        self.conv2 = conv(width, width, 3, stride=stride, padding=dilation,
                          groups=groups, dilation=dilation)
        self.bn2 = norm_layer(width)
        self.conv3 = conv(width, planes * self.expansion, 1)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    """``depth`` in {18, 34, 50, 101, 152}; ``width`` is the bottleneck's
    base width (128 for the wide variants)."""

    _cfg = {18: (BasicBlock, [2, 2, 2, 2]),
            34: (BasicBlock, [3, 4, 6, 3]),
            50: (BottleneckBlock, [3, 4, 6, 3]),
            101: (BottleneckBlock, [3, 4, 23, 3]),
            152: (BottleneckBlock, [3, 8, 36, 3])}

    def __init__(self, block=None, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block is None or isinstance(block, int):
            block, layers = self._cfg[depth]
        else:
            layers = self._cfg[depth][1]
        self._device = device
        self._generator = generator
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, device=device,
                            generator=generator)
        self.bn1 = BatchNorm2D(self.inplanes, device=device)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             device=device, generator=generator)

    def _make_layer(self, block, planes, blocks, stride=1):
        kw = dict(device=self._device, generator=self._generator)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **kw),
                BatchNorm2D(planes * block.expansion,
                            device=self._device))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(depth, pretrained=False, **kwargs):
    if pretrained:
        raise UnimplementedError(
            "pretrained weights are not bundled; load a checkpoint with "
            "load_state_dict (convert.state_from_jax for the JAX "
            "package's)")
    return ResNet(depth=depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(101, pretrained, width=128, **kwargs)
