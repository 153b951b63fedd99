from . import lr
from .optimizer import (ASGD, FUSED_OPT_FALLBACK_REASONS, SGD, Adadelta,
                        Adagrad, Adam, Adamax, AdamW, Lamb, Momentum,
                        Optimizer, RMSProp, Rprop, fused_counters)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "FUSED_OPT_FALLBACK_REASONS", "Lamb", "Momentum", "Optimizer",
           "RMSProp", "Rprop", "SGD", "fused_counters", "lr"]
