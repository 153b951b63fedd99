"""``paddle.vision`` (counterpart of ``paddle_tpu/vision/__init__.py``):
``transforms``, ``datasets``, ``models`` (the zoo, YOLOv3 among it) and
``ops``."""

from . import datasets, models, ops, transforms  # noqa: F401
from .datasets import MNIST, Cifar10, Cifar100, FashionMNIST  # noqa: F401
from .models import (  # noqa: F401
    VGG, LeNet, MobileNetV1, MobileNetV2, MobileNetV3Large,
    MobileNetV3Small, ResNet, alexnet, resnet18, resnet34, resnet50,
    resnet101, resnet152, vgg11, vgg13, vgg16, vgg19)

__all__ = ["transforms", "datasets", "models", "ops"]
