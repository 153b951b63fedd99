from .device import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, dtype_of,
                     get_device, layer_device, resolve_device, set_device)

__all__ = ["CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "Place", "dtype_of",
           "get_device", "layer_device", "resolve_device", "set_device"]
