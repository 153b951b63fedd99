"""``paddle.nn``: ``Layer``, the common layers, the initializers, the
losses, ``functional``, the grad clips, the transformer encoder, the
recurrent layers, the MoE layers, ``LayerStack`` and ``quant``
(counterpart of ``paddle_tpu/nn/__init__.py``; ``SyncBatchNorm``
reduces its statistics over the data-parallel ranks)."""

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
    Softmax, Softplus, Softsign, Swish, SyncBatchNorm, Tanh, Upsample)
from .layers_common import __all__ as _LAYERS
from .loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss,
                   L1Loss, MSELoss, NLLLoss, SmoothL1Loss)
from .moe import ExpertFFN, MoELayer, TopKGate
from .rnn import GRU, LSTM, GRUCell, LSTMCell, SimpleRNN, SimpleRNNCell
from .stack import LayerStack
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = sorted(set(_LAYERS) | {
    "BCELoss", "BCEWithLogitsLoss", "ClipGradBase", "ClipGradByGlobalNorm",
    "ClipGradByNorm", "ClipGradByValue", "CrossEntropyLoss", "ExpertFFN",
    "GRU", "GRUCell", "KLDivLoss", "L1Loss", "LSTM", "LSTMCell", "Layer",
    "LayerStack", "LazyGuard", "MSELoss", "MoELayer", "MultiHeadAttention",
    "NLLLoss", "ParamAttr", "ParamInit", "SimpleRNN", "SimpleRNNCell",
    "SmoothL1Loss", "TopKGate", "TransformerEncoder",
    "TransformerEncoderLayer", "functional", "initializer", "quant"})
