"""Layer: the module base class, as a ``torch.nn.Module``.

Counterpart of ``paddle_tpu/nn/layer_base.py:27-356``: ``LazyGuard``,
``Parameter`` (with ``trainable``) and ``Layer`` with Paddle's methods
(``add_parameter``, ``add_sublayer``, ``create_parameter``,
``named_sublayers``, ``sublayers``, ``register_forward_pre_hook`` /
``register_forward_post_hook``, ``set_state_dict`` / ``load_dict``,
``astype``, ``to(device, dtype)``). A ``Layer`` IS a ``torch.nn.Module``:
torch's callers (the optimizer, ``TrainStep`` and step capture's
parameter walk, ``torch.func.functional_call``, ``hapi``) see a module,
and the methods whose Paddle signature differs from torch's
(``named_parameters(prefix, include_sublayers)``, ``parameters``,
``state_dict(destination, include_sublayers, structured_name_prefix)``,
``train()`` / ``eval()``, ``to``) take torch's keywords too. State-dict
names are torch's, which are the reference's (``a.b.weight``).

A new parameter goes to the device ``core.device.set_device`` names (the
card by default), in the layer's dtype (float32 unless given) unless the
initializer carries its own (``ParamInit``). Under ``LazyGuard`` it is a
meta tensor and its initializer runs at the owning layer's first call (or
:func:`materialize`), into the same ``Parameter`` object, so an optimizer
built before then keeps it.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import dtype_of, layer_device, place_of
from ..core.tensor import paddle_call
from . import initializer as I

_LAZY = [0]


class LazyGuard:
    """Defer parameter initialization (the reference's ``paddle.LazyGuard``):
    inside the guard, ``create_parameter`` makes meta tensors and records
    the initializer, which runs at the layer's first call."""

    def __enter__(self):
        _LAZY[0] += 1
        return self

    def __exit__(self, *exc):
        _LAZY[0] -= 1
        return False


class Parameter(nn.Parameter):
    """A trainable tensor: ``trainable`` is ``requires_grad``.

    A ``Parameter`` keeps torch's meaning for the names that Paddle's
    ``Tensor`` gives another (``shape``, ``size``, ``reshape``, ``sum``,
    ``grad``, ...): the optimizers and the models call them. It has the
    Paddle properties that do not clash: ``stop_gradient``, ``place``,
    ``inplace_version``, ``clear_gradient`` / ``clear_grad``,
    ``set_value``, ``numpy()`` (read from the card), ``name`` and
    ``persistable``."""

    persistable = True

    def __new__(cls, data=None, trainable: bool = True):
        return super().__new__(cls, data, requires_grad=trainable)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.requires_grad_(not value)

    @property
    def place(self):
        return place_of(self.device)

    @property
    def inplace_version(self) -> int:
        return self._version

    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value) -> None:
        self.__dict__["_name"] = value

    def clear_gradient(self, set_to_zero: bool = False) -> None:
        if set_to_zero and self.grad is not None:
            self.grad.zero_()
        else:
            self.grad = None

    clear_grad = clear_gradient

    def set_value(self, value) -> None:
        """Write ``value`` (a tensor or array of this shape) in place."""
        src = value if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.asarray(value))
        with torch.no_grad():
            self.copy_(src.to(device=self.device, dtype=self.dtype)
                       .reshape(self.shape))

    def numpy(self) -> np.ndarray:
        """A numpy copy, read from the card; bfloat16 widens to float32."""
        t = self.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu().numpy(), copy=True)


def _dtype(dtype) -> torch.dtype:
    return dtype_of(dtype) if dtype is not None else torch.float32


def materialize(layer: nn.Module) -> None:
    """Run the deferred initializers of every lazy parameter under
    ``layer``."""
    for sub in layer.modules():
        if sub.__dict__.pop("_has_lazy", None):
            for p in sub._parameters.values():
                spec = getattr(p, "_lazy_spec", None)
                if spec is not None:
                    init, shape, dtype, device = spec
                    del p._lazy_spec
                    with torch.no_grad():
                        real = Parameter(init(shape, dtype, device),
                                         trainable=p.requires_grad)
                    torch.utils.swap_tensors(p, real)


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        self._dtype = _dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- registry -------------------------------------------------------------
    def add_parameter(self, name: str, parameter):
        if parameter is not None:
            self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer: nn.Module) -> nn.Module:
        self.add_module(name, sublayer)
        return sublayer

    def create_parameter(self, shape, dtype=None, default_initializer=None,
                         is_bias: bool = False, attr=None
                         ) -> Optional[Parameter]:
        """``shape`` and an initializer -> a ``Parameter``; ``attr`` is a
        ``ParamAttr`` (its initializer wins over ``default_initializer``,
        its ``trainable`` is kept) or False (no parameter). The default is
        zeros for a bias, else XavierNormal, as in the reference."""
        if attr is False:
            return None
        dtype = _dtype(dtype) if dtype is not None else self._dtype
        init = default_initializer
        if attr is not None and getattr(attr, "initializer", None) is not None:
            init = attr.initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        shape = tuple(int(s) for s in shape)
        trainable = attr is None or getattr(attr, "trainable", True)
        if isinstance(init, I.ParamInit):
            dtype, device = init.dtype, init.device
        else:
            device = layer_device()
        if _LAZY[0] > 0:
            p = Parameter(torch.empty(shape, dtype=dtype, device="meta"),
                          trainable=trainable)
            p._lazy_spec = (init, shape, dtype, device)
            self.__dict__["_has_lazy"] = True
            return p
        return Parameter(init(shape, dtype, device), trainable=trainable)

    # -- iteration ------------------------------------------------------------
    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         remove_duplicate: bool = True, *,
                         recurse: Optional[bool] = None
                         ) -> Iterator[Tuple[str, nn.Parameter]]:
        recurse = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix, recurse, remove_duplicate)

    def parameters(self, include_sublayers: bool = True, *,
                   recurse: Optional[bool] = None) -> List[nn.Parameter]:
        recurse = include_sublayers if recurse is None else recurse
        return [p for _, p in self.named_parameters(recurse=recurse)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False
                        ) -> Iterator[Tuple[str, nn.Module]]:
        for name, layer in self.named_modules(prefix=prefix.rstrip(".")):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # -- modes, dtype, device -------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to``, with Paddle's dtype names (``"float32"``) and
        ``to(device=..., dtype=...)``; ``blocking`` is accepted."""
        kwargs.pop("blocking", None)
        args = [dtype_of(a) if isinstance(a, str) and a in _DTYPE_NAMES
                else a for a in args]
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = dtype_of(kwargs["dtype"])
        if isinstance(kwargs.get("device"), str):
            kwargs["device"] = kwargs["device"].replace("gpu", "cuda")
        args = [a.replace("gpu", "cuda") if isinstance(a, str) else a
                for a in args]
        out = super().to(*args, **kwargs)
        dtype = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if dtype is not None:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = dtype
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- state dict -----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers: bool = True,
                   structured_name_prefix: str = "", *, prefix: str = "",
                   keep_vars: bool = False):
        """Parameters and persistable buffers by dotted name (torch's
        ``state_dict``; ``include_sublayers=False`` keeps this layer's
        own)."""
        prefix = prefix or structured_name_prefix
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        out = destination if destination is not None \
            else collections.OrderedDict()
        self._save_to_state_dict(out, prefix, keep_vars)
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy each entry (tensor or numpy) into the tensor of the same
        name; returns ``(missing, unexpected)``; a shape mismatch
        raises."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        for k, v in state_dict.items():
            if k not in own:
                continue
            target = own[k]
            src = v.detach() if isinstance(v, torch.Tensor) else \
                torch.as_tensor(_float_array(v))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(f"shape mismatch for {k!r}: "
                                 f"{tuple(src.shape)} vs expected "
                                 f"{tuple(target.shape)}")
            target.copy_(src.to(device=target.device, dtype=target.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    # -- hooks ----------------------------------------------------------------
    def register_forward_post_hook(self, hook: Callable):
        """``hook(layer, inputs, output)``; a non-None result replaces the
        output (torch's forward hook)."""
        return self.register_forward_hook(hook)

    # -- call -----------------------------------------------------------------
    def __call__(self, *inputs, **kwargs):
        if "_has_lazy" in self.__dict__:
            materialize(self)
        return paddle_call(super().__call__, inputs, kwargs)


_DTYPE_NAMES = ("float32", "bfloat16", "float16", "float64", "int8",
                "int32", "int64")


def _float_array(v) -> np.ndarray:
    """A numpy array, bf16 (from JAX) widened to float32."""
    arr = np.asarray(v)
    return arr.astype(np.float32) if str(arr.dtype) == "bfloat16" else arr


__all__ = ["Layer", "LazyGuard", "Parameter", "materialize"]
