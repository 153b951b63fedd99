"""Shape and layout ops, search and sort.

Counterparts of ``paddle_tpu/ops/kernels/manipulation.py:16-275`` (the
manipulation ops but ``flatten``, ``pad`` and ``one_hot``, which live with
the layer ops in ``nn.py``) and ``:277-380`` (search and sort). Index
outputs are int64 (``argmax``, ``argmin``, ``argsort``, ``topk``,
``searchsorted`` unless ``out_int32``, ``nonzero``, ``numel``,
``shape_op``, ``bincount`` counts), where the reference's are int32;
``sort`` and ``argsort`` are stable.

The ops whose output shape depends on the data (``nonzero``,
``masked_select``, ``unique``, ``histogram``, ``bincount``: ``jit: false``
in the reference's table, whose compile would fail on them) raise
:class:`DataDependentShapeError` while a step is being captured.
"""

from __future__ import annotations

import torch

from ...core.device import dtype_of
from ..dispatcher import register_kernel
from . import fused_optimizer as _fok


class DataDependentShapeError(RuntimeError):
    """An op whose output shape depends on the data ran while a step was
    captured: a graph has fixed shapes."""


def _not_captured(name: str) -> None:
    if _fok.capture_active():
        raise DataDependentShapeError(
            f"op '{name}': its output shape depends on the data, which a "
            f"captured step cannot hold; run it outside the step")


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    return [int(v)] if isinstance(v, int) else [int(a) for a in v]


@register_kernel("reshape")
def _reshape(x, shape):
    return torch.reshape(x, _ints(shape))


@register_kernel("transpose")
def _transpose(x, perm):
    return x.permute(_ints(perm))


@register_kernel("swapaxes")
def _swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, int(axis1), int(axis2))


@register_kernel("moveaxis")
def _moveaxis(x, source, destination):
    return torch.movedim(x, _ints(source), _ints(destination))


@register_kernel("concat")
def _concat(xs, axis=0):
    return torch.cat(list(xs), dim=int(axis))


@register_kernel("stack")
def _stack(xs, axis=0):
    return torch.stack(list(xs), dim=int(axis))


@register_kernel("split")
def _split(x, num_or_sections, axis=0):
    """An int: that many equal pieces; a list: those sizes, one of them
    -1 (or None) for the rest."""
    axis = int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {total} does not divide into "
                             f"{num_or_sections} equal pieces")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    sections = list(num_or_sections)
    if any(s in (-1, None) for s in sections):
        known = sum(s for s in sections if s not in (-1, None))
        sections = [total - known if s in (-1, None) else s
                    for s in sections]
    return list(torch.split(x, [int(s) for s in sections], dim=axis))


@register_kernel("chunk")
def _chunk(x, chunks, axis=0):
    """``np.array_split``: the first ``size % chunks`` pieces one longer."""
    return list(torch.tensor_split(x, int(chunks), dim=int(axis)))


@register_kernel("unstack")
def _unstack(x, axis=0, num=None):
    return list(torch.unbind(x, int(axis)))


@register_kernel("unbind")
def _unbind(x, axis=0):
    return list(torch.unbind(x, int(axis)))


@register_kernel("squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    dims = tuple(a for a in _ints(axis) if x.shape[a] == 1)
    return x.squeeze(dims) if dims else x


@register_kernel("unsqueeze")
def _unsqueeze(x, axis):
    for a in sorted(a if a >= 0 else a + x.dim() + 1 for a in _ints(axis)):
        x = x.unsqueeze(a)
    return x


@register_kernel("expand")
def _expand(x, shape):
    shape = _ints(shape)
    lead = len(shape) - x.dim()
    return x.broadcast_to([x.shape[i - lead] if s == -1 else s
                           for i, s in enumerate(shape)])


@register_kernel("broadcast_to")
def _broadcast_to(x, shape):
    return _expand(x, shape)


@register_kernel("tile")
def _tile(x, repeat_times):
    return torch.tile(x, _ints(repeat_times))


@register_kernel("repeat_interleave")
def _repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_kernel("flip")
def _flip(x, axis):
    return torch.flip(x, _ints(axis))


@register_kernel("roll")
def _roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, _ints(shifts), _ints(axis))


@register_kernel("cast")
def _cast(x, dtype):
    return x.to(dtype_of(dtype))


def _axis_slice(x, ax, st, en, sd=1):
    """One axis sliced as Python slices it (a negative stride as well)."""
    if sd > 0:
        return x[(slice(None),) * (ax % x.dim()) + (slice(st, en, sd),)]
    idx = torch.arange(*slice(st, en, sd).indices(x.shape[ax]),
                       device=x.device)
    return x.index_select(ax, idx)


@register_kernel("slice")
def _slice(x, axes, starts, ends):
    for ax, st, en in zip(_ints(axes), _ints(starts), _ints(ends)):
        x = _axis_slice(x, ax, st, en)
    return x


@register_kernel("strided_slice")
def _strided_slice(x, axes, starts, ends, strides):
    for ax, st, en, sd in zip(_ints(axes), _ints(starts), _ints(ends),
                              _ints(strides)):
        x = _axis_slice(x, ax, st, en, sd)
    return x


def _take(x, index, axis):
    """``jnp.take``: the rows of ``axis`` at ``index`` (any shape)."""
    axis = int(axis) % x.dim()
    index = index.long()
    out = x.index_select(axis, index.reshape(-1))
    return out.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


@register_kernel("gather")
def _gather(x, index, axis=0):
    if index.dim() == 0:
        index = index[None]
    return _take(x, index, axis)


@register_kernel("gather_nd")
def _gather_nd(x, index):
    return x[tuple(index.long().movedim(-1, 0))]


@register_kernel("take_along_axis")
def _take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices.long(), dim=int(axis))


@register_kernel("put_along_axis")
def _put_along_axis(x, indices, values, axis, reduce="assign"):
    idx = indices.long()
    values = torch.as_tensor(values, device=x.device).to(x.dtype) \
        .broadcast_to(idx.shape)
    axis = int(axis)
    if reduce == "assign":
        return x.scatter(axis, idx, values)
    if reduce in ("add", "sum"):
        return x.scatter_add(axis, idx, values)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, idx, values, "prod")
    raise ValueError(f"unknown reduce {reduce}")


@register_kernel("scatter")
def _scatter(x, index, updates, overwrite=True):
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    index, updates = index.long(), updates.to(x.dtype)
    if overwrite:
        return x.index_put((index,), updates)
    return x.index_put((index,), updates, accumulate=True)


@register_kernel("scatter_nd_add")
def _scatter_nd_add(x, index, updates):
    return x.index_put(tuple(index.long().movedim(-1, 0)),
                       updates.to(x.dtype), accumulate=True)


@register_kernel("index_select")
def _index_select(x, index, axis=0):
    return _take(x, index, axis)


@register_kernel("index_add")
def _index_add(x, index, axis, value):
    return x.index_add(int(axis), index.long(), value.to(x.dtype))


@register_kernel("where")
def _where(condition, x=None, y=None):
    if x is None and y is None:
        _not_captured("where")
        return torch.nonzero(condition, as_tuple=True)
    return torch.where(condition.bool(), x, y)


@register_kernel("masked_fill")
def _masked_fill(x, mask, value):
    value = torch.as_tensor(value, device=x.device).to(x.dtype)
    return torch.where(mask.bool(), value, x)


@register_kernel("tril")
def _tril(x, diagonal=0):
    return torch.tril(x, int(diagonal))


@register_kernel("triu")
def _triu(x, diagonal=0):
    return torch.triu(x, int(diagonal))


@register_kernel("numel")
def _numel(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@register_kernel("shape_op")
def _shape_op(x):
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


@register_kernel("as_real")
def _as_real(x):
    return torch.stack([x.real, x.imag], dim=-1)


@register_kernel("as_complex")
def _as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


# -- search / sort ------------------------------------------------------------

def _index_dtype(dtype):
    return torch.int64 if dtype is None else dtype_of(dtype)


@register_kernel("argmax")
def _argmax(x, axis=None, keepdim=False, dtype=None):
    out = torch.argmax(x) if axis is None else \
        torch.argmax(x, dim=int(axis), keepdim=keepdim)
    return out.to(_index_dtype(dtype))


@register_kernel("argmin")
def _argmin(x, axis=None, keepdim=False, dtype=None):
    out = torch.argmin(x) if axis is None else \
        torch.argmin(x, dim=int(axis), keepdim=keepdim)
    return out.to(_index_dtype(dtype))


@register_kernel("argsort")
def _argsort(x, axis=-1, descending=False, stable=True):
    return torch.sort(x, dim=int(axis), descending=descending,
                      stable=True).indices


@register_kernel("sort")
def _sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=int(axis), descending=descending,
                      stable=True).values


@register_kernel("topk")
def _topk(x, k, axis=-1, largest=True, sorted=True):
    vals, idx = torch.topk(x, int(k), dim=int(axis), largest=largest,
                           sorted=True)
    return vals, idx


@register_kernel("searchsorted")
def _searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


@register_kernel("bincount")
def _bincount(x, weights=None, minlength=0):
    _not_captured("bincount")
    out = torch.bincount(x.long(), weights, int(minlength))
    return out if weights is None else out.to(weights.dtype)


@register_kernel("histogram")
def _histogram(x, bins=100, min=0.0, max=0.0):
    """Counts (int64) over ``bins`` equal bins of [min, max], the last
    closed; min == max == 0 takes the data's range."""
    _not_captured("histogram")
    x = x.float()
    if min == 0.0 and max == 0.0:
        min, max = float(x.min()), float(x.max())
    return torch.histc(x, int(bins), min, max).long()


@register_kernel("nonzero")
def _nonzero(x, as_tuple=False):
    """The ``[n, x.dim()]`` indices of the nonzero elements (the reference
    ignores ``as_tuple``, and so does the port)."""
    _not_captured("nonzero")
    return torch.nonzero(x)


@register_kernel("masked_select")
def _masked_select(x, mask):
    _not_captured("masked_select")
    return x[mask.bool()]


@register_kernel("unique")
def _unique(x, return_index=False, return_inverse=False,
            return_counts=False, axis=None):
    """The sorted unique values (or slices along ``axis``), then, as
    asked, the index of each one's first occurrence, the inverse and
    the counts."""
    _not_captured("unique")
    src = x.reshape(-1) if axis is None else x
    dim = 0 if axis is None else int(axis)
    uniq, inverse, counts = torch.unique(src, sorted=True,
                                         return_inverse=True,
                                         return_counts=True, dim=dim)
    out = [uniq]
    if return_index:
        pos = torch.arange(src.shape[dim], device=x.device)
        first = torch.full((uniq.shape[dim],), src.shape[dim],
                           dtype=torch.int64, device=x.device)
        out.append(first.scatter_reduce(0, inverse, pos, "amin"))
    if return_inverse:
        out.append(inverse)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)
