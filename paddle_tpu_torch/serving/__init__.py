"""paddle_tpu_torch.serving: serving-side subsystems (counterpart of
``paddle_tpu/serving/``).

The engines themselves live in :mod:`paddle_tpu_torch.models.serving`
(re-exported here); :mod:`paddle_tpu_torch.serving.resilience` wraps them
with journal/replay, drain, and warm-start;
:mod:`paddle_tpu_torch.serving.fleet` routes traffic over N resilient
replicas with exactly-once failover and SLO-aware shedding.
"""

from ..models.serving import (ContinuousBatchingEngine,  # noqa: F401
                              GangScheduledEngine, PrefixCache, QueueFull,
                              Request)
from . import fleet  # noqa: F401
from . import resilience  # noqa: F401

__all__ = [
    "ContinuousBatchingEngine", "GangScheduledEngine", "PrefixCache",
    "QueueFull", "Request", "resilience", "fleet",
]
