"""LeNet (port of ``paddle1_tpu/vision/models/lenet.py``), BASELINE
config 1's model: the same layers and attribute paths, so state names
match the JAX package's (``features.0.weight``, ``fc.2.bias``, ...).

Its parameters are Paddle :class:`~paddle1_tpu_torch.core.tensor.Parameter`s
(``stop_gradient``, ``trainable``, ``numpy()``), so a forward on
``to_tensor`` inputs returns a Paddle ``Tensor``. It takes ``device``
(default: the current place, ``set_device``, which is the card until
set) and ``generator`` (for seeded weights).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...core.place import get_device
from ...core.tensor import as_paddle_parameters
from ...nn.layer_base import Layer
from ...nn.layer_common import Linear
from ...nn.layer_conv_pool import Conv2D, MaxPool2D
from ...nn.layer_norm_act import ReLU, Sequential
from ...ops import manip_ops

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes: int = 10, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        if device is None:
            device = get_device().torch_device()
        conv = functools.partial(Conv2D, device=device, generator=generator)
        self.features = Sequential(
            conv(1, 6, 3, stride=1, padding=1),
            ReLU(),
            MaxPool2D(2, 2),
            conv(6, 16, 5, stride=1, padding=0),
            ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            lin = functools.partial(Linear, device=device,
                                    generator=generator)
            self.fc = Sequential(lin(400, 120), lin(120, 84),
                                 lin(84, num_classes))
        as_paddle_parameters(self)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(manip_ops.flatten(x, 1))
        return x
