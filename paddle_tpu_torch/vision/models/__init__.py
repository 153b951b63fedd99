"""``paddle.vision.models``: the model zoo (counterpart of
``paddle_tpu/vision/models/__init__.py``). Each model keeps the
reference's parameter and buffer names, so ``models.from_jax_state_dict``
loads a JAX model into it; ``pretrained=True`` raises (no weights are
bundled)."""

from .lenet import LeNet  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, resnet18, resnet34, resnet50, resnet101, resnet152,
    resnext50_32x4d, resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
    resnext152_32x4d, resnext152_64x4d, wide_resnet50_2, wide_resnet101_2,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNetV1, mobilenet_v1, MobileNetV2, mobilenet_v2,
    MobileNetV3Small, MobileNetV3Large, mobilenet_v3_small, mobilenet_v3_large,
)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .yolov3 import YOLOv3, yolov3_darknet53  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
)
from .shufflenetv2 import (  # noqa: F401
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish,
)
from .googlenet import (  # noqa: F401
    GoogLeNet, googlenet, InceptionV3, inception_v3,
)
