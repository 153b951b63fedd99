from .api import TrainStep
from .step_capture import (FALLBACK_REASONS, CaptureAbort, CapturedStep,
                           capture_counters, jit_step)

__all__ = ["CaptureAbort", "CapturedStep", "FALLBACK_REASONS", "TrainStep",
           "capture_counters", "jit_step"]
