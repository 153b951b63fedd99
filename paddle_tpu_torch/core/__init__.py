from .device import dtype_of, resolve_device

__all__ = ["dtype_of", "resolve_device"]
