"""``paddle.distributed``: activation recomputation and the preemption
signal handler (``fleet.PreemptionHandler``), for now (the rest, over
``torch.distributed``, is ROADMAP A8)."""

from . import fleet  # noqa: F401
from .recompute import dots_saveable, recompute, recompute_sequential

__all__ = ["dots_saveable", "recompute", "recompute_sequential", "fleet"]
