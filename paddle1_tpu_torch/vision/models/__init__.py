"""ResNet, LeNet, MobileNetV1/V2, VGG and YOLOv3 with its training loss
(``paddle1_tpu.vision.models`` subset)."""

from . import mobilenet, mobilenetv1, mobilenetv2, vgg  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        mobilenet_v1, mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2, wide_resnet101_2)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .yolo import (ConvBNLeaky, DarkBlock, DarkNet53,  # noqa: F401
                   YoloDetBlock, YOLOv3, yolov3, yolov3_loss)
