"""Tensor creation ops and ``getitem``.

Counterparts of ``paddle_tpu/ops/kernels/creation.py:15-104`` and
``manipulation.py:163`` (``getitem``). An op with no tensor argument makes
its output on the port's default device (``core.device.set_device``; the
card unless the caller chose the CPU); a ``_like`` op on its argument's.
A float default is float32, as the reference's default dtype. Integer
outputs are int64, Paddle's documented dtype and the one torch's indexing
takes, where the reference (JAX with x64 off) gives int32: ``full`` with an
int fill, ``arange`` over ints, ``tril_indices``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.device import dtype_of, layer_device
from ..dispatcher import register_kernel


def _dt(dtype, default=torch.float32):
    return default if dtype is None else dtype_of(dtype)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@register_kernel("full")
def _full(shape=(), fill_value=0.0, dtype=None):
    fill_value = _scalar(fill_value)
    if dtype is None:
        dtype = torch.bool if isinstance(fill_value, bool) else \
            torch.int64 if isinstance(fill_value, (int, np.integer)) else \
            torch.float32
    return torch.full(_shape(shape), fill_value, dtype=dtype_of(dtype),
                      device=layer_device())


@register_kernel("full_like")
def _full_like(x, fill_value=0.0, dtype=None):
    return torch.full_like(x, _scalar(fill_value), dtype=_dt(dtype, x.dtype))


@register_kernel("zeros")
def _zeros(shape=(), dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=layer_device())


@register_kernel("ones")
def _ones(shape=(), dtype=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=layer_device())


@register_kernel("zeros_like")
def _zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_dt(dtype, x.dtype))


@register_kernel("ones_like")
def _ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=_dt(dtype, x.dtype))


@register_kernel("empty")
def _empty(shape=(), dtype=None):
    """Zeros, as the reference's ``empty``: never uninitialized memory."""
    return _zeros(shape, dtype)


@register_kernel("empty_like")
def _empty_like(x, dtype=None):
    return _zeros_like(x, dtype)


@register_kernel("arange")
def _arange(start=0, end=None, step=1, dtype=None):
    """``arange(end)`` or ``arange(start, end, step)``; ints give int64,
    a float bound or step float32."""
    start, end, step = (_scalar(v) for v in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None and not all(isinstance(v, (int, np.integer))
                                 for v in (start, end, step)):
        dtype = torch.float32
    return torch.arange(start, end, step, device=layer_device(),
                        dtype=None if dtype is None else dtype_of(dtype))


@register_kernel("linspace")
def _linspace(start, stop, num, dtype=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype), device=layer_device())


@register_kernel("eye")
def _eye(num_rows, num_columns=None, dtype=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=layer_device())


@register_kernel("tril_indices")
def _tril_indices(rows, cols, offset=0):
    return torch.tril_indices(int(rows), int(cols), int(offset),
                              device=layer_device())


@register_kernel("diag")
def _diag(x, offset=0):
    return torch.diag(x, int(offset))


@register_kernel("diagflat")
def _diagflat(x, offset=0):
    return torch.diagflat(x, int(offset))


@register_kernel("meshgrid")
def _meshgrid(xs):
    return list(torch.meshgrid(*xs, indexing="ij"))


@register_kernel("assign")
def _assign(x):
    """A copy of a tensor (its grad flows back), or a numpy array / list
    as a tensor on the default device."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=layer_device())


def _index(index, device) -> Any:
    """The reference's index forms as torch takes them: ints, slices,
    None and Ellipsis as they are; arrays, lists and index tensors as
    tensors on ``device`` (bool kept, integers as int64)."""
    if isinstance(index, tuple):
        return tuple(_index(i, device) for i in index)
    if index is None or index is Ellipsis or isinstance(index, (int, slice)):
        return index
    if isinstance(index, np.integer):
        return int(index)
    t = index if isinstance(index, torch.Tensor) \
        else torch.as_tensor(np.asarray(index))
    if t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


def _consumed(i) -> int:
    """How many dims of x one index element consumes (Ellipsis aside)."""
    if i is None:
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return i.dim()
    return 1


def has_reversed_slice(index) -> bool:
    """Whether ``index`` holds a slice with a negative step, which torch's
    indexing refuses."""
    index = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, slice) and (i.step or 1) < 0 for i in index)


def _reverse_slices(x, index):
    """A slice with a negative step (which torch's indexing lacks) applied
    as an ``index_select`` of its positions, and replaced by ``:``."""
    items = list(index)
    if not has_reversed_slice(index):
        return x, index
    n_ell = x.dim() - sum(_consumed(i) for i in items if i is not Ellipsis)
    dim = 0
    for k, i in enumerate(items):
        if isinstance(i, slice) and (i.step or 1) < 0:
            pos = torch.arange(*i.indices(x.shape[dim]), device=x.device)
            x = x.index_select(dim, pos)
            items[k] = slice(None)
        dim += n_ell if i is Ellipsis else _consumed(i)
    return x, tuple(items)


@register_kernel("getitem")
def _getitem(x, index=None):
    index = _index(index, x.device)
    x, index = _reverse_slices(x, index if isinstance(index, tuple)
                               else (index,))
    return x[index]


def set_at(x, index, value):
    """``x`` with ``x[index] = value``, a new tensor whose grads reach
    ``x`` outside the written places and ``value`` (the reference's
    ``x.at[index].set(value)``). A slice with a negative step, which
    torch's indexing refuses, is written through the flat positions that
    :func:`_getitem` reads there."""
    index = _index(index, x.device)
    index = index if isinstance(index, tuple) else (index,)
    if not has_reversed_slice(index):
        out = x.clone()
        out[index] = value
        return out
    pos = _getitem(torch.arange(x.numel(), device=x.device).view(x.shape),
                   index)
    while value.dim() > pos.dim() and value.shape[0] == 1:
        value = value[0]
    return x.reshape(-1).index_put(
        (pos.reshape(-1),), value.expand(pos.shape).reshape(-1)
    ).view(x.shape)
