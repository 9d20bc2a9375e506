"""paddle.vision.transforms analog (port of
``paddle1_tpu/vision/transforms``: numpy on the host, as there)."""

from . import functional
from .transforms import (BaseTransform, BrightnessTransform, CenterCrop,
                         ColorJitter, Compose, ContrastTransform, Grayscale,
                         HueTransform, Normalize, Pad, RandomCrop,
                         RandomHorizontalFlip, RandomResizedCrop,
                         RandomRotation, RandomVerticalFlip, Resize,
                         SaturationTransform, ToTensor, Transpose)

__all__ = ["functional", "BaseTransform", "Compose", "ToTensor", "Normalize",
           "Resize", "RandomCrop", "CenterCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "RandomResizedCrop", "RandomRotation",
           "ColorJitter", "Grayscale", "Pad", "Transpose",
           "BrightnessTransform", "ContrastTransform", "SaturationTransform",
           "HueTransform"]
