"""``paddle.vision.transforms`` (counterpart of
``paddle_tpu/vision/transforms/__init__.py``)."""

from .functional import (  # noqa: F401
    to_tensor, resize, pad, crop, center_crop, hflip, vflip,
    adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue,
    rotate, to_grayscale, normalize, erase,
)
from .transforms import (  # noqa: F401
    BaseTransform, Compose, ToTensor, Resize, RandomResizedCrop, CenterCrop,
    RandomHorizontalFlip, RandomVerticalFlip, Transpose, Normalize,
    BrightnessTransform, SaturationTransform, ContrastTransform, HueTransform,
    ColorJitter, RandomCrop, Pad, RandomRotation, Grayscale, RandomErasing,
)
