from .optimizer import (FUSED_OPT_FALLBACK_REASONS, SGD, Adam, AdamW,
                        Momentum, Optimizer, fused_counters)

__all__ = ["Adam", "AdamW", "FUSED_OPT_FALLBACK_REASONS", "Momentum",
           "Optimizer", "SGD", "fused_counters"]
