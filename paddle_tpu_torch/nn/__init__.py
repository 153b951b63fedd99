from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue)
from .initializer import ParamInit
from .moe import ExpertFFN, MoELayer, TopKGate

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "ExpertFFN", "MoELayer", "ParamInit",
           "TopKGate"]
