"""The differentiable op forms behind ``tensor_api``'s long-tail functions.

Counterparts of ``paddle_tpu/ops/kernels/tensor_api_ext.py`` (the ops of
``ops.yaml:809-819``; ``pca_lowrank`` draws, so it lives with the random
ops): ``tensordot_impl`` with the reference's size-1 rule, ``inner``,
``pdist`` (rows (0,1), (0,2), ..., (N-2,N-1)), ``cumulative_trapezoid``,
``combinations`` (lexicographic), the diagonal / select / slice scatters
into a copy, and ``scatter_nd`` (duplicate indices add).
"""

from __future__ import annotations

import itertools

import torch

from ..dispatcher import register_kernel


@register_kernel("tensordot_impl")
def _tensordot_impl(x, y, axes_x=(), axes_y=()):
    ax = tuple(int(a) for a in axes_x)
    ay = tuple(int(a) for a in axes_y)
    # a size-1 dim paired with a size-n one sums the other operand there
    for a, b in zip(ax, ay):
        sx, sy = x.shape[a], y.shape[b]
        if sx == 1 and sy != 1:
            y = y.sum(dim=b, keepdim=True)
        elif sy == 1 and sx != 1:
            x = x.sum(dim=a, keepdim=True)
    return torch.tensordot(x, y, dims=(list(ax), list(ay)))


@register_kernel("inner")
def _inner(x, y):
    if x.dim() == 0 or y.dim() == 0:
        return x * y
    return torch.inner(x, y)


@register_kernel("pdist")
def _pdist(x, p=2.0):
    n = x.shape[0]
    iu, ju = torch.triu_indices(n, n, offset=1, device=x.device)
    diff = x[iu] - x[ju]
    if p == 0:
        return (diff != 0).sum(-1).to(x.dtype)
    if p == float("inf"):
        return diff.abs().amax(-1)
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.sum(diff.abs() ** p, dim=-1) ** (1.0 / p)


@register_kernel("cumulative_trapezoid")
def _cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    n = y.shape[axis]
    y0, y1 = y.narrow(axis, 0, n - 1), y.narrow(axis, 1, n - 1)
    if x is not None:
        if x.dim() == 1:
            shape = [1] * y.dim()
            shape[axis] = x.shape[0]
            x = x.reshape(shape)
        m = x.shape[axis]
        d = x.narrow(axis, 1, m - 1) - x.narrow(axis, 0, m - 1)
        seg = (y0 + y1) / 2.0 * d
    else:
        seg = (y0 + y1) / 2.0 * (1.0 if dx is None else dx)
    return torch.cumsum(seg, dim=axis)


@register_kernel("combinations")
def _combinations(x, r=2, with_replacement=False):
    n = x.shape[0]
    pick = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = list(pick(range(n), int(r)))
    if not idx:
        return torch.zeros((0, int(r)), dtype=x.dtype, device=x.device)
    return x[torch.tensor(idx, dtype=torch.int64, device=x.device)]


@register_kernel("diagonal_scatter")
def _diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    return torch.diagonal_scatter(x, y.to(x.dtype), int(offset), int(axis1),
                                  int(axis2))


@register_kernel("select_scatter")
def _select_scatter(x, values, axis=0, index=0):
    return torch.select_scatter(x, values.to(x.dtype), int(axis), int(index))


@register_kernel("slice_scatter")
def _slice_scatter(x, value, axes=(), starts=(), ends=(), strides=()):
    idx = [slice(None)] * x.dim()
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx[int(ax) % x.dim()] = slice(int(s), int(e), int(st))
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


@register_kernel("scatter_nd")
def _scatter_nd(index, updates, shape=()):
    zeros = torch.zeros([int(s) for s in shape], dtype=updates.dtype,
                        device=updates.device)
    if index.shape[-1] == 0:
        return zeros + updates.reshape(zeros.shape)
    idx = tuple(index.long().movedim(-1, 0))
    return zeros.index_put(idx, updates, accumulate=True)
