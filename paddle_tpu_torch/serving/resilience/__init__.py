"""Serving-side resilience: request journal + replay, drain-on-SIGTERM,
prefix-cache warm-start (counterpart of
``paddle_tpu/serving/resilience/``)."""

from .engine import ResilientServingEngine, ServingAction  # noqa: F401
from .journal import JournalState, RequestJournal  # noqa: F401
from .warm_cache import (load_prefix_cache,  # noqa: F401
                         snapshot_prefix_cache)

__all__ = [
    "ResilientServingEngine", "ServingAction", "RequestJournal",
    "JournalState", "snapshot_prefix_cache", "load_prefix_cache",
]
