"""The long-tail top-level functions of the Paddle surface.

Counterpart of ``paddle_tpu/tensor_api.py``: ``mm``, ``inner``,
``tensordot`` (with the reference's axes normalization), ``pdist``,
``histogramdd``, ``cumulative_trapezoid``, ``combinations``, the
diagonal / select / slice scatters, ``scatter_nd``, ``broadcast_shape``,
``randint_like``, ``standard_normal``, ``rank``, ``tolist``, ``view``,
``clone``, the dtype predicates, ``triu_indices``, ``where_``,
``floor_mod``, ``set_printoptions``, ``in_dynamic_mode``, ``batch``,
``check_shape``, and ``_attach_tensor_methods`` (:419). The grad-mode and
rng-state functions it re-exports live in ``autograd`` and
``core.generator``. Each returns ``Tensor``s; the differentiable ones run
the registry's ops.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .autograd import set_grad_enabled  # noqa: F401
from .core import dtype as _dtype_mod
from .core.device import layer_device
from .core.generator import (default_generator, get_cuda_rng_state,  # noqa
                             get_rng_state, set_cuda_rng_state,
                             set_rng_state)
from .core.tensor import Tensor, public, unwrap, wrap
from .ops.dispatcher import inplace_apply, public_op

__all__ = [
    "mm", "inner", "tensordot", "pdist", "histogramdd",
    "cumulative_trapezoid", "combinations", "diagonal_scatter",
    "select_scatter", "slice_scatter", "scatter_nd", "broadcast_shape",
    "randint_like", "standard_normal", "rank", "tolist", "view", "clone",
    "is_complex", "is_floating_point", "is_integer", "triu_indices",
    "where_", "floor_mod", "set_printoptions", "set_grad_enabled",
    "get_rng_state", "set_rng_state", "get_cuda_rng_state",
    "set_cuda_rng_state", "in_dynamic_mode", "disable_signal_handler",
    "batch", "check_shape",
]


def _dt(x) -> torch.dtype:
    return unwrap(x).dtype if isinstance(x, torch.Tensor) else \
        torch.as_tensor(x).dtype


def mm(input, mat2):
    """Matrix product without broadcasting."""
    return public_op("matmul")(input, mat2)


def inner(x, y):
    """Sum-product over the last dimension."""
    return public_op("inner")(x, y)


def tensordot(x, y, axes=2):
    """An int ``axes`` contracts x's last n with y's first n; a flat list
    applies to both; a pair of lists is per operand, the shorter extended
    with the other's tail (the reference's normalization)."""
    def to_list(a):
        return unwrap(a).tolist() if isinstance(a, torch.Tensor) else a
    axes = to_list(axes)
    if isinstance(axes, (int, np.integer)):
        if axes < 0:
            raise ValueError(f"'axes' should not be negative, got {axes}")
        nx = len(x.shape)
        axes_x, axes_y = list(range(nx - axes, nx)), list(range(axes))
    else:
        axes = [to_list(a) for a in axes]
        if not axes or isinstance(axes[0], (int, np.integer)):
            axes_x, axes_y = list(axes), []
        else:
            axes_x = list(axes[0])
            axes_y = list(axes[1]) if len(axes) > 1 else []
        if len(axes_x) < len(axes_y):
            axes_x.extend(axes_y[len(axes_x):])
        elif len(axes_y) < len(axes_x):
            axes_y.extend(axes_x[len(axes_y):])
    return public_op("tensordot_impl")(x, y, axes_x=axes_x, axes_y=axes_y)


def pdist(x, p: float = 2.0):
    """Condensed pairwise p-norm distances of an ``[N, D]`` matrix."""
    return public_op("pdist")(x, p=float(p))


def histogramdd(x, bins=10, ranges=None, density: bool = False,
                weights=None):
    """Multidimensional histogram of an ``[N, D]`` sample -> ``(hist,
    edges)`` (numpy's, on the sample's device)."""
    t = unwrap(x)
    a = t.detach().cpu().numpy()
    if weights is not None:
        weights = unwrap(weights).detach().cpu().numpy()
    if isinstance(bins, (list, tuple)) and bins and \
            isinstance(bins[0], torch.Tensor):
        bins = [unwrap(b).detach().cpu().numpy() for b in bins]
    rng = None
    if ranges is not None:
        flat = list(ranges)
        rng = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]
    hist, edges = np.histogramdd(a, bins=bins, range=rng, density=density,
                                 weights=weights)
    out_dt = np.float32 if density else a.dtype
    return (wrap(torch.as_tensor(hist.astype(out_dt), device=t.device)),
            [wrap(torch.as_tensor(e.astype(a.dtype), device=t.device))
             for e in edges])


def cumulative_trapezoid(y, x=None, dx: Optional[float] = None,
                         axis: int = -1):
    """Cumulative trapezoidal integral (size n - 1 along ``axis``)."""
    if x is not None and dx is not None:
        raise ValueError("either x or dx should be provided, not both")
    return public_op("cumulative_trapezoid")(y, x, dx=dx, axis=int(axis))


def combinations(x, r: int = 2, with_replacement: bool = False):
    """r-combinations of a 1-D tensor -> ``[C, r]``."""
    return public_op("combinations")(x, r=int(r),
                                     with_replacement=bool(with_replacement))


def diagonal_scatter(x, y, offset: int = 0, axis1: int = 0, axis2: int = 1):
    return public_op("diagonal_scatter")(x, y, offset=int(offset),
                                         axis1=int(axis1), axis2=int(axis2))


def select_scatter(x, values, axis: int, index: int):
    return public_op("select_scatter")(x, values, axis=int(axis),
                                       index=int(index))


def slice_scatter(x, value, axes: Sequence[int], starts: Sequence[int],
                  ends: Sequence[int], strides: Sequence[int]):
    return public_op("slice_scatter")(x, value, axes=list(axes),
                                      starts=list(starts), ends=list(ends),
                                      strides=list(strides))


def scatter_nd(index, updates, shape: Sequence[int]):
    """Zeros of ``shape`` with ``updates`` added at ``index``."""
    return public_op("scatter_nd")(index, updates,
                                   shape=[int(s) for s in shape])


def broadcast_shape(x_shape: Sequence[int], y_shape: Sequence[int]
                    ) -> List[int]:
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def randint_like(x, low: int = 0, high: Optional[int] = None, dtype=None):
    """Random ints in ``[low, high)`` of ``x``'s shape, on its device, from
    the port's generator for that device."""
    if high is None:
        low, high = 0, low
    t = unwrap(x)
    dt = _dtype_mod.convert_dtype(dtype) or t.dtype
    out = torch.randint(int(low), int(high), tuple(t.shape),
                        generator=default_generator(t.device),
                        device=t.device, dtype=torch.int64)
    return wrap(out.to(dt))


def standard_normal(shape, dtype=None):
    return public_op("gaussian")(shape=shape, dtype=dtype)


def rank(input):
    """The number of dimensions, as a 0-d int tensor."""
    t = unwrap(input)
    return wrap(torch.tensor(t.dim(), dtype=torch.int32, device=t.device))


def tolist(x) -> list:
    return unwrap(x).tolist()


def view(x, shape_or_dtype):
    """A reshape (a list or tuple) or a bitcast to a dtype of another
    width (the last dimension scales by the width ratio)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return public_op("reshape")(x, shape=[int(s) for s in
                                              shape_or_dtype])
    dt = _dtype_mod.convert_dtype(shape_or_dtype)
    return public(lambda t: t.view(dt))(x)


def clone(x):
    """A differentiable copy."""
    return public(torch.clone)(x)


def is_complex(x) -> bool:
    return _dt(x).is_complex


def is_floating_point(x) -> bool:
    return _dt(x).is_floating_point


def is_integer(x) -> bool:
    dt = _dt(x)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def triu_indices(row: int, col: Optional[int] = None, offset: int = 0,
                 dtype="int64"):
    """``[2, n]`` row and column indices of the upper triangle."""
    if col is None:
        col = row
    out = torch.triu_indices(int(row), int(col), int(offset),
                             device=layer_device())
    return wrap(out.to(_dtype_mod.dtype_of(dtype)))


def where_(condition, x, y):
    """In-place where: writes ``where(condition, x, y)`` into ``x`` (the
    written operand is ``x``, not the first argument)."""
    from .ops.dispatcher import get_op
    return inplace_apply(x, lambda snap, c, y_: get_op("where")(c, snap, y_),
                         (condition, y))


def floor_mod(x, y):
    """``remainder``."""
    return public_op("remainder")(x, y)


_sci_state = [False]


def set_printoptions(precision: Optional[int] = None,
                     threshold: Optional[int] = None,
                     edgeitems: Optional[int] = None,
                     sci_mode: Optional[bool] = None,
                     linewidth: Optional[int] = None) -> None:
    """Tensor repr formatting: numpy's print options, which the repr
    uses (``sci_mode=True`` installs a scientific float formatter)."""
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth)) if v is not None}
    if sci_mode is not None:
        _sci_state[0] = bool(sci_mode)
        kw["suppress"] = not sci_mode
    if _sci_state[0]:
        prec = precision if precision is not None \
            else np.get_printoptions()["precision"]
        kw["formatter"] = {"float_kind": lambda v, _p=prec:
                           np.format_float_scientific(v, precision=_p,
                                                      unique=False)}
    elif sci_mode is not None:
        kw["formatter"] = None
    np.set_printoptions(**kw)


def in_dynamic_mode() -> bool:
    """Always True: the port has no static-graph mode."""
    return True


def disable_signal_handler() -> None:
    """A no-op: the port installs no signal handlers."""


def check_shape(shape) -> None:
    """Entries must be ints (or -1 placeholders), or tensors."""
    if isinstance(shape, torch.Tensor):
        return
    for s in shape:
        if isinstance(s, torch.Tensor):
            continue
        if not isinstance(s, (int, np.integer)):
            raise TypeError(f"shape entries must be int, got {type(s)}")
        if s < -1:
            raise ValueError(f"invalid dim {s} in shape")


def batch(reader, batch_size: int, drop_last: bool = False):
    """A reader decorator grouping samples into lists of ``batch_size``."""
    if not isinstance(batch_size, (int, np.integer)) or batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")

    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def _attach_tensor_methods() -> None:
    """This module's tensor-first functions as ``Tensor`` methods (the
    reference's ``_attach_tensor_methods``); a name ``Tensor`` already
    defines keeps its definition."""
    fns = [mm, inner, tensordot, pdist, histogramdd, cumulative_trapezoid,
           combinations, diagonal_scatter, select_scatter, slice_scatter,
           scatter_nd, randint_like, rank, view, is_complex,
           is_floating_point, is_integer, where_, floor_mod]
    for fn in fns:
        if fn.__name__ not in ("is_floating_point", "is_complex"):
            setattr(Tensor, fn.__name__, fn)

    def _broadcast_shape_method(self, y_shape):
        return broadcast_shape(self.shape, y_shape)

    Tensor.broadcast_shape = _broadcast_shape_method
    Tensor.is_tensor = staticmethod(
        lambda x: isinstance(x, torch.Tensor))
