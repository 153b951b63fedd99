"""The Paddle ``Tensor``: a ``torch.Tensor`` subclass with Paddle's surface.

Counterpart of ``paddle_tpu/core/tensor.py`` (the ``Tensor`` class,
``to_tensor``). The reference's Tensor is a handle over an immutable
``jax.Array``; the port's IS a ``torch.Tensor`` (made by ``__class__``
assignment or ``_make_subclass``, never by a copy), so torch's autograd
graph, CUDA graphs and the port's kernels see it as they see any tensor.

Paddle in, Paddle out; torch in, torch out. Some names mean one thing in
Paddle and another in torch (``shape`` is a list, ``size`` the element
count, ``transpose(perm)``, ``reshape(shape)``, ``sum(axis)``,
``max`` without indices, ``split(num_or_sections, axis)``, ``to("gpu:0")``,
``numpy()`` from the card, ...). On a ``Tensor`` the Paddle meaning holds;
inside the port the torch meaning holds, and no port internal ever sees a
``Tensor``:

- ``Tensor.__torch_function__`` unwraps every ``Tensor`` argument (an
  alias, ``as_subclass(torch.Tensor)``, which keeps the autograd edge)
  before it calls the torch function, and wraps the tensor results back:
  Python-level torch code (``F.batch_norm`` calling ``input.size()``)
  never sees a ``Tensor``. An alias that comes back (an in-place method
  returns ``self``) is mapped back to its ``Tensor``. The property getters
  and setters and the methods in :data:`SELF_METHODS` run on the
  ``Tensor`` itself: they read or change its own autograd metadata.
- The port's entry points (``ops.dispatcher.call_op``, ``nn.Layer``'s
  call, the models' and criteria's calls, ``TrainStep``, ``jit_step``) go
  through :func:`paddle_call`: ``Tensor`` arguments are unwrapped, and the
  results wrapped back only when an argument was a ``Tensor``. The
  top-level functions and the ``Tensor`` methods always return
  ``Tensor``s (:func:`public`).

A result that was an argument of the call and not a ``Tensor`` (a plain
tensor the caller passed and the op handed back) is wrapped as an alias,
so the caller's plain tensor keeps its class. Other plain results are
fresh objects and are made ``Tensor``s in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from .device import Place, _as_device, layer_device, place_of

_TB = torch._C.TensorBase
_NoSubclassTF = torch._C.DisableTorchFunctionSubclass

# Methods that run on the Tensor itself in __torch_function__ (not on an
# alias): they read or change the tensor's own autograd state or storage
# binding, which an alias does not share.
SELF_METHODS = frozenset({
    "requires_grad_", "detach_", "retain_grad",
    "register_post_accumulate_grad_hook", "_use_count", "_is_view",
    "set_", "resize_", "resize_as_", "share_memory_", "__setstate__",
    "_fix_weakref",
})
# The torch names a Tensor keeps as torch defines them: the autograd
# engine, torch.utils.swap_tensors and __torch_function__ read them, and
# no Paddle op method of the same name may replace them (the method
# attach in ops.dispatcher skips these and the names this class defines).
TORCH_OWNED = frozenset({
    "grad", "grad_fn", "requires_grad", "requires_grad_", "is_leaf",
    "data", "device", "dtype", "ndim", "_version", "_base", "detach",
    "detach_", "retain_grad", "retains_grad", "clone", "cpu", "cuda",
    "contiguous", "is_contiguous", "stride", "data_ptr", "element_size",
    "storage_offset", "untyped_storage", "dim", "new_empty", "new_zeros",
    "new_ones", "new_full", "new_tensor", "type", "is_floating_point",
    "is_complex", "_use_count", "_is_view", "__class__", "__dict__",
})
# getters whose tensor result is not wrapped (it is another object's)
_RAW_GETTERS = frozenset({"_base"})


def _plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain ``torch.Tensor`` (an alias: same storage, same
    version counter, attached to ``t``'s autograd graph)."""
    return _TB.as_subclass(t, torch.Tensor)


class _Call:
    """One crossing of the boundary: the aliases made for the Tensor
    arguments, and the plain tensors the caller passed."""

    __slots__ = ("aliases", "plain_ids")

    def __init__(self):
        self.aliases: Dict[int, Any] = {}    # id(original) -> alias
        self.plain_ids: Dict[int, Any] = {}  # id(alias or plain) -> orig

    def unwrap(self, v):
        if isinstance(v, Tensor):
            a = self.aliases.get(id(v))
            if a is None:
                a = _plain(v)
                self.aliases[id(v)] = a
                self.plain_ids[id(a)] = v
            return a
        if isinstance(v, torch.Tensor):
            self.plain_ids[id(v)] = None
            return v
        if type(v) in (list, tuple):
            return type(v)(self.unwrap(x) for x in v)
        if type(v) is dict:
            return {k: self.unwrap(x) for k, x in v.items()}
        return v

    def wrap(self, v):
        if type(v) is torch.Tensor:
            key = id(v)
            if key in self.plain_ids:
                orig = self.plain_ids[key]
                return orig if orig is not None else \
                    _TB.as_subclass(v, Tensor)
            v.__class__ = Tensor
            return v
        if isinstance(v, tuple):
            items = [self.wrap(x) for x in v]
            if hasattr(v, "_fields"):
                return type(v)(*items)
            return type(v)(items) if type(v) is not tuple else tuple(items)
        if type(v) is list:
            return [self.wrap(x) for x in v]
        if type(v) is dict:
            return {k: self.wrap(x) for k, x in v.items()}
        return v


def has_tensor(v) -> bool:
    if isinstance(v, Tensor):
        return True
    if type(v) in (list, tuple):
        return any(has_tensor(x) for x in v)
    if type(v) is dict:
        return any(has_tensor(x) for x in v.values())
    return False


def unwrap(v):
    """``v`` with every ``Tensor`` in it (through lists, tuples and dicts)
    replaced by a plain alias."""
    return _Call().unwrap(v)


def wrap(v):
    """``v`` with every plain tensor in it made a ``Tensor`` (in place)."""
    return _Call().wrap(v)


def paddle_call(fn: Callable, args, kwargs):
    """``fn(*args, **kwargs)`` at a port entry point: ``Tensor`` arguments
    are unwrapped, and the results wrapped back when one was given."""
    if not (has_tensor(args) or has_tensor(kwargs)):
        return fn(*args, **kwargs)
    c = _Call()
    args, kwargs = c.unwrap(args), c.unwrap(kwargs)
    return c.wrap(fn(*args, **kwargs))


def public(fn: Callable) -> Callable:
    """``fn`` as a function of the Paddle surface: ``Tensor`` arguments
    unwrapped, tensor results always ``Tensor``s."""
    def call(*args, **kwargs):
        c = _Call()
        args, kwargs = c.unwrap(args), c.unwrap(kwargs)
        return c.wrap(fn(*args, **kwargs))
    call.__name__ = call.__qualname__ = getattr(fn, "__name__", "op")
    call.__doc__ = fn.__doc__
    if hasattr(fn, "__signature__"):
        call.__signature__ = fn.__signature__
    call.__wrapped_op__ = fn
    return call


class PaddleCall:
    """Mixin for an ``nn.Module`` entry point (a model, a criterion):
    Paddle in, Paddle out at its call."""

    def __call__(self, *args, **kwargs):
        return paddle_call(super().__call__, args, kwargs)


def _parse_to(args, kwargs):
    """(device, dtype, copy) of Paddle's ``to(device, dtype, blocking)``
    and torch's ``to(...)`` forms."""
    device = kwargs.pop("device", None)
    dtype = kwargs.pop("dtype", None)
    copy = bool(kwargs.pop("copy", False))
    kwargs.pop("blocking", None)
    kwargs.pop("non_blocking", None)
    for a in args:
        if isinstance(a, torch.Tensor):
            device, dtype = a.device, a.dtype
        elif isinstance(a, (torch.dtype, np.dtype)) or (
                isinstance(a, str) and a in dtype_mod._STR2DTYPE) or (
                isinstance(a, type) and a in (float, int, bool)):
            dtype = a
        elif isinstance(a, (str, torch.device, Place)):
            device = a
    return (None if device is None else _as_device(device),
            dtype_mod.convert_dtype(dtype), copy)


class Tensor(torch.Tensor):
    """A ``torch.Tensor`` with Paddle's methods and properties. Make one
    with :func:`to_tensor` (or ``Tensor(data, dtype, place,
    stop_gradient)``); the top-level ops and the methods return them."""

    persistable = False

    def __new__(cls, data=None, dtype=None, place=None,
                stop_gradient: bool = True, name: Optional[str] = None):
        t = to_tensor([] if data is None else data, dtype, place,
                      stop_gradient)
        if name is not None:
            t.name = name
        return t

    def __init__(self, *args, **kwargs):
        pass

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fname = getattr(func, "__name__", "")
        if fname in ("__get__", "__set__", "__delete__") \
                or fname in SELF_METHODS:
            with _NoSubclassTF():
                out = func(*args, **kwargs)
            if fname == "__get__" and type(out) is torch.Tensor and \
                    getattr(func.__self__, "__name__", "") \
                    not in _RAW_GETTERS:
                out.__class__ = Tensor
            return out
        c = _Call()
        args, kwargs = c.unwrap(args), c.unwrap(kwargs)
        with _NoSubclassTF():
            out = func(*args, **kwargs)
        return c.wrap(out)

    # -- properties ------------------------------------------------------------
    @property
    def shape(self):
        with _NoSubclassTF():
            return list(_TB.size(self))

    @property
    def size(self) -> int:
        with _NoSubclassTF():
            return _TB.numel(self)

    @property
    def place(self) -> Place:
        return place_of(self.device)

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        with _NoSubclassTF():
            if not value:
                if not self.requires_grad:
                    self.requires_grad_(True)
                return
            if not self.requires_grad:
                return
            if self.is_leaf:
                self.requires_grad_(False)
            elif not self._is_view():
                self.detach_()
            else:
                _rebind(self, self.detach())

    @property
    def inplace_version(self) -> int:
        with _NoSubclassTF():
            return self._version + self.__dict__.get("_rebinds", 0)

    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value) -> None:
        self.__dict__["_name"] = value

    @property
    def T(self) -> "Tensor":
        from ..ops.dispatcher import public_op
        return public_op("transpose")(
            self, perm=list(range(self.ndim))[::-1])

    # -- conversion ------------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A numpy copy, read from the card if the tensor lives there;
        bfloat16 widens to float32 (numpy has no bfloat16)."""
        with _NoSubclassTF():
            t = _TB.detach(self)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu().numpy(), copy=True)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *idx):
        with _NoSubclassTF():
            t = _TB.detach(self)
        return (t[idx] if idx else t).item()

    def tolist(self):
        with _NoSubclassTF():
            return _TB.tolist(self)

    def astype(self, dtype) -> "Tensor":
        from ..ops.dispatcher import public_op
        return public_op("cast")(self, dtype)

    def to(self, *args, **kwargs) -> "Tensor":
        device, dtype, copy = _parse_to(args, dict(kwargs))
        return public(lambda t: t.to(device=device, dtype=dtype,
                                     copy=copy))(self)

    def set_value(self, value) -> None:
        """Write ``value`` into this tensor's storage (no autograd)."""
        src = unwrap(value) if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.asarray(value))
        with torch.no_grad():
            t = _plain(self)
            t.copy_(src.to(device=t.device, dtype=t.dtype).reshape(t.shape))

    # -- autograd --------------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        grads = None if grad_tensor is None else [unwrap(grad_tensor)]
        torch.autograd.backward([_plain(self)], grads,
                                retain_graph=retain_graph)

    def clear_gradient(self, set_to_zero: bool = False) -> None:
        with _NoSubclassTF():
            if set_to_zero and self.grad is not None:
                self.grad.zero_()
            else:
                self.grad = None

    clear_grad = clear_gradient

    def register_hook(self, hook: Callable):
        """``hook(grad)`` on the tensor's fully accumulated gradient (a
        ``Tensor``); a non-None result replaces it. Returns a handle with
        ``remove()``."""
        def run(g):
            res = hook(_TB.as_subclass(g, Tensor))
            return None if res is None else unwrap(res)
        with _NoSubclassTF():
            return torch.Tensor.register_hook(self, run)

    # -- Python protocol -------------------------------------------------------
    __hash__ = torch.Tensor.__hash__

    def __repr__(self):
        g = "" if not self.requires_grad else ", stop_gradient=False"
        body = np.array2string(self.numpy(), prefix="       ")
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}{g},\n       {body})")

    __str__ = __repr__

    def __getitem__(self, idx):
        from ..ops.dispatcher import public_op
        return public_op("getitem")(self, index=idx)

    def __setitem__(self, idx, value):
        with _NoSubclassTF():
            if self.requires_grad and not self.is_leaf:
                raise RuntimeError(
                    "in-place __setitem__ on a non-leaf tensor that requires "
                    "grad is not supported; use paddle.where / scatter")
        v = unwrap(value) if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.asarray(value))
        from ..ops.kernels.creation import has_reversed_slice, set_at
        idx = unwrap(idx)
        with torch.no_grad():
            t = _plain(self)
            v = v.to(device=t.device, dtype=t.dtype)
            if has_reversed_slice(idx):
                t.copy_(set_at(t, idx, v))
            else:
                t[idx] = v

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __deepcopy__(self, memo):
        import copy
        with _NoSubclassTF():
            if not self.is_leaf:
                raise RuntimeError("Only Tensors created explicitly by the "
                                   "user support the deepcopy protocol")
            t = _TB.detach(self).clone()
        out = _from_plain(t, self.requires_grad,
                          copy.deepcopy(self.__dict__, memo))
        memo[id(self)] = out
        return out

    def __reduce_ex__(self, proto):
        with _NoSubclassTF():
            t = _TB.detach(self)
            return (_from_plain, (t, self.requires_grad,
                                  dict(self.__dict__)))


def _from_plain(t: torch.Tensor, requires_grad: bool = False,
                state: Optional[dict] = None) -> Tensor:
    """A leaf ``Tensor`` over ``t``'s storage."""
    out = torch.Tensor._make_subclass(Tensor, t, requires_grad)
    if state:
        out.__dict__.update(state)
    return out


def _rebind(target: torch.Tensor, new: torch.Tensor) -> None:
    """Make ``target`` hold ``new``'s data and autograd history (the
    reference's buffer rebind, for an inplace op that changes the shape or
    the dtype): its identity, class and attributes stay, its
    ``inplace_version`` goes up by one."""
    with _NoSubclassTF():
        version = target._version + target.__dict__.get("_rebinds", 0)
        state = dict(target.__dict__)
        state["_rebinds"] = version + 1 - new._version
        new.__class__ = type(target)
        new.__dict__.update(state)
        try:
            torch.utils.swap_tensors(target, new)
        except RuntimeError as e:
            raise RuntimeError(
                "cannot rebind a tensor that the autograd graph still "
                f"holds (it was saved by a later op): {e}") from None


def to_tensor(data, dtype=None, place=None, stop_gradient: bool = True
              ) -> Tensor:
    """``paddle.to_tensor``: a new leaf ``Tensor`` (a copy) from host data
    or a tensor, on ``place`` (default: ``set_device``'s device, the card
    unless the caller chose the CPU). A Python or numpy float64 without
    ``dtype`` takes the default dtype (float32)."""
    device = _as_device(place) if place is not None else layer_device()
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        src = unwrap(data).detach()
        t = src.to(device=device, dtype=dt or src.dtype, copy=True)
    else:
        if isinstance(data, (list, tuple)) and any(
                isinstance(x, torch.Tensor) for x in data):
            data = [unwrap(x).detach().cpu().float().numpy()
                    if isinstance(x, torch.Tensor) and x.dtype ==
                    torch.bfloat16 else
                    (unwrap(x).detach().cpu().numpy()
                     if isinstance(x, torch.Tensor) else x) for x in data]
        arr = np.asarray(data)
        if arr.dtype.name == "bfloat16":
            arr, dt = arr.astype(np.float32), dt or torch.bfloat16
        if dt is None:
            if arr.dtype == np.float64:
                dt = dtype_mod.get_default_dtype()
            elif arr.dtype == np.complex128:
                dt = torch.complex64
        t = torch.tensor(arr, device=device)
        if dt is not None:
            t = t.to(dt)
    return _from_plain(t, not stop_gradient)


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


__all__ = ["Tensor", "to_tensor", "is_tensor", "paddle_call", "public",
           "unwrap", "wrap", "PaddleCall", "SELF_METHODS", "TORCH_OWNED"]
