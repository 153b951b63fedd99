"""Class-style transforms (counterpart of
``paddle_tpu/vision/transforms/transforms.py``). Each is callable on an HWC
numpy image (``Normalize`` on a ``Tensor`` too) and draws its randomness
from Python's ``random`` (``RandomErasing``'s "random" fill from numpy's),
as the reference's do; a tuple input is transformed item by item.
"""

from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np

from . import functional as F

__all__ = [
    "BaseTransform", "Compose", "ToTensor", "Resize", "RandomResizedCrop",
    "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose",
    "Normalize", "BrightnessTransform", "SaturationTransform",
    "ContrastTransform", "HueTransform", "ColorJitter", "RandomCrop", "Pad",
    "RandomRotation", "Grayscale", "RandomErasing",
]


class BaseTransform:
    """Base: applies `_apply_image` to each input (tuple inputs supported)."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        if isinstance(inputs, tuple):
            return tuple(self._apply_image(x) for x in inputs)
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


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


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        if isinstance(size, int):
            size = (size, size)
        self.size, self.scale, self.ratio = size, scale, ratio
        self.interpolation = interpolation

    def _get_param(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(random.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                return top, left, ch, cw
        # center-crop fallback
        s = min(h, w)
        return (h - s) // 2, (w - s) // 2, s, s

    def _apply_image(self, img):
        img = F._as_hwc(img)
        top, left, ch, cw = self._get_param(img)
        img = F.crop(img, top, left, ch, cw)
        return F.resize(img, self.size, self.interpolation)


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
        if random.random() < self.prob:
            return F.hflip(img)
        return F._as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return F.vflip(img)
        return F._as_hwc(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.transpose(F._as_hwc(img), self.order)


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
        self.to_rgb = to_rgb

    def _apply_image(self, img):
        if self.to_rgb:
            img = np.asarray(img)
            img = img[::-1, :, :] if self.data_format == "CHW" \
                else img[:, :, ::-1]
        return F.normalize(img, self.mean, self.std, self.data_format)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._as_hwc(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_brightness(img, factor)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value should be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._as_hwc(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_contrast(img, factor)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._as_hwc(img)
        factor = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return F.adjust_saturation(img, factor)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return F._as_hwc(img)
        factor = random.uniform(-self.value, self.value)
        return F.adjust_hue(img, factor)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, keys=None):
        super().__init__(keys)
        self.transforms = [
            BrightnessTransform(brightness), ContrastTransform(contrast),
            SaturationTransform(saturation), HueTransform(hue),
        ]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.transforms[i]._apply_image(img)
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding, self.pad_if_needed = padding, pad_if_needed
        self.fill, self.padding_mode = fill, padding_mode

    def _apply_image(self, img):
        img = F._as_hwc(img)
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        th, tw = self.size
        h, w = img.shape[:2]
        if self.pad_if_needed and w < tw:
            img = F.pad(img, (tw - w, 0), self.fill, self.padding_mode)
        if self.pad_if_needed and h < th:
            img = F.pad(img, (0, th - h), self.fill, self.padding_mode)
        h, w = img.shape[:2]
        if h == th and w == tw:
            return img
        top = random.randint(0, h - th)
        left = random.randint(0, w - tw)
        return F.crop(img, top, left, th, tw)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding, self.fill, self.padding_mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation, self.expand = interpolation, expand
        self.center, self.fill = center, fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        img = F._as_hwc(img)
        if random.random() >= self.prob:
            return img
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            aspect = np.exp(random.uniform(np.log(self.ratio[0]),
                                           np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target / aspect)))
            ew = int(round(np.sqrt(target * aspect)))
            if eh < h and ew < w:
                top = random.randint(0, h - eh)
                left = random.randint(0, w - ew)
                if self.value == "random":
                    v = np.random.randint(0, 256, (eh, ew, img.shape[2]),
                                          dtype=np.uint8)
                else:
                    v = self.value
                return F.erase(img, top, left, eh, ew, v, self.inplace)
        return img
