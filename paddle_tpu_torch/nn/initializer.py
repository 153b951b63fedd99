"""Weight initializers, ``ParamAttr``, and where the port's parameters are
made.

Counterpart of ``paddle_tpu/nn/initializer.py``: the nine initializers
(``Constant``, ``Normal``, ``TruncatedNormal``, ``Uniform``,
``XavierNormal``, ``XavierUniform``, ``KaimingNormal``,
``KaimingUniform``, ``Assign``) with the reference's fan rule
(``_fan_in_out``: a 2-D weight is Paddle's ``[in, out]``, so fan-in is
``shape[0]``; a conv kernel ``[out, in/groups, *k]``), and ``ParamAttr``.
Each is a callable ``(shape, dtype, device) -> torch.Tensor``. torch's own
``nn.init`` is not used: its fan rule reads a 2-D weight as ``[out, in]``.

The draws come from explicit generators, never from torch's global one:
an initializer's own ``generator=``, else the port's generator for the
device (:func:`default_generator`), which :func:`seed` reseeds (the
reference's ``paddle.seed``). The draws cannot match JAX's threefry bits;
they match the reference by shape, dtype, fan and moments.

``ParamInit`` is the models' initializer: normal(0, std) draws from one
explicit generator on one device in one dtype, so a seed fixes a whole
model; its ``attr()`` hands it to a layer as ``weight_attr``. Real or
reference weights are loaded with ``models.convert.from_jax_state_dict``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, dtype_of, resolve_device
from ..core.generator import default_generator, seed  # noqa: F401

def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = 1                     # conv kernels [out_c, in_c, *spatial]
    for s in shape[2:]:
        rf *= s
    return shape[1] * rf, shape[0] * rf


class Initializer:
    """``init(shape, dtype, device)`` -> a new tensor."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.generator = generator

    def _gen(self, device) -> torch.Generator:
        return self.generator if self.generator is not None \
            else default_generator(device)

    def __call__(self, shape, dtype=torch.float32, device=None):
        raise NotImplementedError

    def _normal(self, shape, dtype, device, mean, std):
        w = torch.empty(tuple(shape), dtype=dtype_of(dtype),
                        device=resolve_device(device))
        return w.normal_(mean, std, generator=self._gen(w.device))

    def _uniform(self, shape, dtype, device, low, high):
        w = torch.empty(tuple(shape), dtype=dtype_of(dtype),
                        device=resolve_device(device))
        return w.uniform_(low, high, generator=self._gen(w.device))


class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__()
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        return torch.full(tuple(shape), self.value, dtype=dtype_of(dtype),
                          device=resolve_device(device))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, generator=None):
        super().__init__(generator)
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None):
        return self._normal(shape, dtype, device, self.mean, self.std)


class TruncatedNormal(Initializer):
    """``mean + std * z``, z normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal(-2, 2)``)."""

    def __init__(self, mean=0.0, std=1.0, generator=None):
        super().__init__(generator)
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None):
        w = torch.empty(tuple(shape), dtype=torch.float32,
                        device=resolve_device(device))
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                              generator=self._gen(w.device))
        return (self.mean + self.std * w).to(dtype_of(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, generator=None):
        super().__init__(generator)
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device=None):
        return self._uniform(shape, dtype, device, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, generator=None):
        super().__init__(generator)
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi, fo = _fan_in_out(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return self._normal(shape, dtype, device, 0.0, std)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, generator=None):
        super().__init__(generator)
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi, fo = _fan_in_out(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return self._uniform(shape, dtype, device, -limit, limit)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 generator=None):
        super().__init__(generator)
        self.fan_in, self.a = fan_in, negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi = self.fan_in or _fan_in_out(shape)[0]
        std = math.sqrt(2.0 / (1 + self.a ** 2)) / math.sqrt(fi)
        return self._normal(shape, dtype, device, 0.0, std)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 generator=None):
        super().__init__(generator)
        self.fan_in, self.a = fan_in, negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None):
        fi = self.fan_in or _fan_in_out(shape)[0]
        limit = math.sqrt(2.0 / (1 + self.a ** 2)) * math.sqrt(3.0 / fi)
        return self._uniform(shape, dtype, device, -limit, limit)


class Assign(Initializer):
    def __init__(self, value):
        super().__init__()
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None):
        v = self.value
        t = v.detach() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        t = t.to(device=resolve_device(device), dtype=dtype_of(dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape {tuple(t.shape)} "
                             f"!= {tuple(shape)}")
        return t.clone()


class ParamAttr:
    """Paddle's ``ParamAttr``: the initializer and trainability of one
    parameter (``learning_rate`` and ``regularizer`` are kept, unread, as
    in the reference)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 trainable=True, regularizer=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable
        self.regularizer = regularizer


class ParamInit(Initializer):
    """The models' initializer: device, dtype, and the generator the
    normal(0, std) draws come from. As an initializer it ignores the
    dtype and device it is asked for and uses its own."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator, std: float = 0.02):
        super().__init__(generator)
        self.device, self.dtype, self.std = device, dtype, std

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

    def __call__(self, shape, dtype=None, device=None):
        w = torch.empty(tuple(shape), device=self.device, dtype=self.dtype)
        return w.normal_(0.0, self.std, generator=self.generator)

    def attr(self) -> ParamAttr:
        """This initializer as a layer's ``weight_attr``."""
        return ParamAttr(initializer=self)

    def normal(self, *shape) -> nn.Parameter:
        return nn.Parameter(self(shape))

    def ones(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(*shape, device=self.device,
                                       dtype=self.dtype))


__all__ = ["Assign", "Constant", "Initializer", "KaimingNormal",
           "KaimingUniform", "Normal", "ParamAttr", "ParamInit",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "default_generator", "seed"]
