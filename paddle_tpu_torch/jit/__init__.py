from .api import TrainStep

__all__ = ["TrainStep"]
