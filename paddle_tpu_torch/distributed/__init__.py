"""``paddle.distributed``: activation recomputation only, for now (the
rest, over ``torch.distributed``, is ROADMAP A8)."""

from .recompute import dots_saveable, recompute, recompute_sequential

__all__ = ["dots_saveable", "recompute", "recompute_sequential"]
