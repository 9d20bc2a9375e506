"""VGG (port of ``paddle1_tpu/vision/models/vgg.py``; Simonyan and
Zisserman 2014): ``VGG`` and ``vgg11/13/16/19``, with ``batch_norm=``
a ``BatchNorm2D`` after every convolution. The same attribute paths as the
JAX package (``features.0.weight``, ``features.1._mean``,
``classifier.0.weight``, ...), so ``convert.state_from_jax`` loads its
``functional_state()`` unchanged.

Every layer takes ``device`` (default: the current place, the card until
``set_device``) and ``generator`` (for seeded weights). Under
``conv_nhwc`` (``auto``: CUDA) the features carry channels-last memory
from the first convolution on, so each batch norm runs its kernel on a
free ``[rows, C]`` view: the given-statistics forward in eval, the
training forward and backward in training.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.errors import UnimplementedError
from ...nn.layer_base import Layer
from ...nn.layer_common import Dropout, Linear
from ...nn.layer_conv_pool import AdaptiveAvgPool2D, Conv2D, MaxPool2D
from ...nn.layer_norm_act import BatchNorm2D, ReLU, Sequential

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, *, device=None,
                generator: Optional[torch.Generator] = None):
    """The feature extractor of one configuration: 3 x 3 convolutions
    (padding 1), each followed by a batch norm when ``batch_norm`` and a
    ReLU, and 2 x 2 max pools at ``"M"``."""
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
            continue
        layers.append(Conv2D(in_channels, v, 3, padding=1, device=device,
                             generator=generator))
        if batch_norm:
            layers.append(BatchNorm2D(v, device=device))
        layers.append(ReLU())
        in_channels = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            kw = dict(device=device, generator=generator)
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, 4096, **kw), ReLU(), Dropout(),
                Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm=False, pretrained=False, *, device=None,
         generator=None, **kwargs):
    if pretrained:
        raise UnimplementedError(
            "pretrained weights are not bundled (no network egress); "
            "load a checkpoint explicitly with paddle.load + set_state_dict")
    return VGG(make_layers(_cfgs[cfg], batch_norm, device=device,
                           generator=generator),
               device=device, generator=generator, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)
