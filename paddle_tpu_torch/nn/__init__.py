"""``paddle.nn``: ``Layer``, the common layers, the initializers, the
losses, ``functional``, the grad clips, the MoE layers, ``LayerStack`` and
``quant`` (counterpart of ``paddle_tpu/nn/__init__.py``; ``SyncBatchNorm``,
``nn/transformer.py`` and ``nn/rnn.py`` are ROADMAP A4/A8)."""

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import quant  # nn.quant, as the reference spells it
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .initializer import ParamAttr, ParamInit
from .layer_base import Layer, LazyGuard, Parameter
from .layers_common import (  # noqa: F401
    ELU, GELU, SELU, AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D,
    BatchNorm1D, BatchNorm2D, BatchNorm3D, Conv1D, Conv2D, Conv2DTranspose,
    Dropout, Dropout2D, Embedding, Flatten, GroupNorm, Hardsigmoid,
    Hardswish, Identity, InstanceNorm2D, LayerList, LayerNorm, LeakyReLU,
    Linear, LogSigmoid, LogSoftmax, MaxPool2D, Mish, Pad2D, ParameterList,
    PixelShuffle, PReLU, ReLU, ReLU6, RMSNorm, Sequential, Sigmoid, SiLU,
    Softmax, Softplus, Softsign, Swish, Tanh, Upsample)
from .layers_common import __all__ as _LAYERS
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss,
                   L1Loss, MSELoss, NLLLoss, SmoothL1Loss)
from .moe import ExpertFFN, MoELayer, TopKGate
from .stack import LayerStack

__all__ = sorted(set(_LAYERS) | {
    "BCELoss", "BCEWithLogitsLoss", "ClipGradBase", "ClipGradByGlobalNorm",
    "ClipGradByNorm", "ClipGradByValue", "CrossEntropyLoss", "ExpertFFN",
    "KLDivLoss", "L1Loss", "Layer", "LayerStack", "LazyGuard", "MSELoss",
    "MoELayer", "NLLLoss", "ParamAttr", "ParamInit", "SmoothL1Loss",
    "TopKGate", "functional", "initializer", "quant"})
