from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .initializer import ParamInit
from .layers_common import Embedding, Linear
from .moe import ExpertFFN, MoELayer, TopKGate
from . import quant  # nn.quant, as the reference spells it

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "Embedding", "ExpertFFN", "Linear", "MoELayer",
           "ParamInit", "TopKGate", "quant"]
