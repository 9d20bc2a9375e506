"""Transform classes (reference python/paddle/vision/transforms/
transforms.py): composable host-side augmentation pipeline.

Port of ``paddle1_tpu/vision/transforms/transforms.py``, unchanged: numpy
arrays on the host, random draws from Python's ``random`` in the same
order, so under one ``random.seed`` both packages give the same arrays
bit for bit."""

from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np

from . import functional as F

__all__ = ["Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
           "RandomCrop", "CenterCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "RandomResizedCrop", "RandomRotation",
           "ColorJitter", "Grayscale", "Pad", "Transpose",
           "BrightnessTransform", "ContrastTransform", "SaturationTransform",
           "HueTransform"]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


class BaseTransform:
    """Keys-aware base (reference transforms.py BaseTransform); subclasses
    implement _apply_image (and optionally _apply_{label,mask,...})."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def __call__(self, inputs):
        if isinstance(inputs, tuple):
            out = []
            for key, x in zip(self.keys, inputs):
                fn = getattr(self, f"_apply_{key}", None)
                out.append(fn(x) if fn else x)
            out.extend(inputs[len(self.keys):])
            return tuple(out)
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__ + "()"


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        arr = np.asarray(img)
        H, W = arr.shape[:2]
        h, w = self.size
        if self.pad_if_needed and (H < h or W < w):
            img = F.pad(img, (max(0, (w - W + 1) // 2),
                              max(0, (h - H + 1) // 2)),
                        self.fill, self.padding_mode)
            arr = np.asarray(img)
            H, W = arr.shape[:2]
        top = random.randint(0, max(0, H - h))
        left = random.randint(0, max(0, W - w))
        return F.crop(img, top, left, h, w)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.hflip(img) if random.random() < self.prob else img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return F.vflip(img) if random.random() < self.prob else img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = np.asarray(img)
        H, W = arr.shape[:2]
        area = H * W
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                top = random.randint(0, H - h)
                left = random.randint(0, W - w)
                patch = F.crop(img, top, left, h, w)
                return F.resize(patch, self.size, self.interpolation)
        return F.resize(F.center_crop(img, min(H, W)), self.size,
                        self.interpolation)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _apply_image(self, img):
        ops = []
        if self.brightness:
            f = random.uniform(max(0, 1 - self.brightness),
                               1 + self.brightness)
            ops.append(lambda im: F.adjust_brightness(im, f))
        if self.contrast:
            f2 = random.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: F.adjust_contrast(im, f2))
        if self.saturation:
            f3 = random.uniform(max(0, 1 - self.saturation),
                                1 + self.saturation)
            ops.append(lambda im: F.adjust_saturation(im, f3))
        if self.hue:
            f4 = random.uniform(-self.hue, self.hue)
            ops.append(lambda im: F.adjust_hue(im, f4))
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return F.adjust_hue(img, random.uniform(-self.value, self.value))
