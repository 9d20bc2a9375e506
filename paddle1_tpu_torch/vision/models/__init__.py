"""ResNet, LeNet and YOLOv3 (``paddle1_tpu.vision.models`` subset)."""

from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2, wide_resnet101_2)
from .yolo import (ConvBNLeaky, DarkBlock, DarkNet53,  # noqa: F401
                   YoloDetBlock, YOLOv3, yolov3)
