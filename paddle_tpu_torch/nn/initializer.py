"""Where and how the port's parameters are made.

The JAX package draws each layer's parameters from its global generator
with per-layer initializers (``paddle_tpu/nn/initializer.py``). The port
draws every weight normal(0, std) from one explicit ``torch.Generator``
and makes norm weights ones, so a seed fixes a whole model; real or
reference weights are loaded with ``models.convert.from_jax_state_dict``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..core.device import DeviceLike, dtype_of, resolve_device


class ParamInit:
    """Device, dtype, and the generator the normal(0, std) draws come
    from."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator, std: float = 0.02):
        self.device, self.dtype = device, dtype
        self.generator, self.std = generator, std

    @classmethod
    def make(cls, device: DeviceLike = None,
             dtype: Union[str, torch.dtype] = "float32",
             generator: Optional[torch.Generator] = None) -> "ParamInit":
        """``device=None`` means the CUDA card (raises when there is
        none); ``generator=None`` a generator on the device seeded 0."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return cls(device, dtype_of(dtype), generator)

    def normal(self, *shape) -> nn.Parameter:
        w = torch.empty(*shape, device=self.device, dtype=self.dtype)
        w.normal_(0.0, self.std, generator=self.generator)
        return nn.Parameter(w)

    def ones(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(*shape, device=self.device,
                                       dtype=self.dtype))
