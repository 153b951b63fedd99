from .device import (dtype_of, get_device, layer_device, resolve_device,
                     set_device)

__all__ = ["dtype_of", "get_device", "layer_device", "resolve_device",
           "set_device"]
