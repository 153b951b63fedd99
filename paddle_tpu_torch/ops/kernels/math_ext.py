"""The long tail of the Tensor-method ops.

Counterparts of the method ops of ``paddle_tpu/ops/kernels/math_ext.py``
(statistics, special math, search and indexing, manipulation) and of
``extra_math.py`` (the gamma family, ``nextafter``, ``nanmedian``, the
shifts, ``fmax`` / ``fmin``, ``reverse``, ``index_sample``, ``index_put``,
``as_strided``, ``tensor_unfold``, ``fill``). Each is a torch call or a
short composite with the reference's semantics: ``kthvalue`` takes the
k-th of a stable sort, ``mode`` the smallest most frequent value and the
index of its last occurrence, ``nanmedian`` averages the two middle
values, ``renorm`` divides by ``norm + 1e-7``, ``masked_scatter`` repeats
the last value when ``value`` runs short, ``take(mode='raise')`` checks
its indices on the host. Index outputs are int64 (the reference: int32).
``gammainc`` / ``gammaincc`` have no gradient with respect to ``x``
(torch has none).

Also the rest of the extended tranche (``ops.yaml:438-494``): ``nanquantile``,
``vander``, ``trapezoid``, ``polar``, ``cdist`` (the reference's
broadcast difference, not ``torch.cdist``'s matmul form), ``crop``, the
stacks, ``block_diag``, ``broadcast_tensors``, ``atleast_{1,2,3}d``,
``diag_embed`` and ``gather_tree`` (the beam backtrace, a loop over time).
"""

from __future__ import annotations

import math

import torch

from ..dispatcher import register_kernel
from .manipulation import _not_captured


def _dims(axis, ndim):
    if axis is None:
        return None
    return [a % ndim for a in ((axis,) if isinstance(axis, int) else axis)]


def _to_last(x, axis):
    """``x`` with the ``axis`` dims moved last and flattened into one, and
    the shape to put back (keepdim)."""
    dims = _dims(axis, x.dim())
    if dims is None:
        return x.reshape(-1), [1] * x.dim()
    rest = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(rest + dims)
    keep = [1 if d in dims else n for d, n in enumerate(x.shape)]
    return moved.reshape([x.shape[d] for d in rest] + [-1]), keep


# -- statistics ---------------------------------------------------------------

def _nearest(fn, flat, qt, skip_nan):
    """JAX's ``nearest`` through ``fn`` (``torch.quantile`` or
    ``torch.nanquantile``): at the position ``q (n - 1)`` over the ``n``
    values (those that are not NaN, with ``skip_nan``), a fraction of 0.5
    or less rounds down (torch's own ``nearest`` rounds half to even)."""
    lo = fn(flat, qt, dim=-1, interpolation="lower")
    hi = fn(flat, qt, dim=-1, interpolation="higher")
    n = (~torch.isnan(flat)).sum(-1).to(flat.dtype) if skip_nan else \
        torch.full(flat.shape[:-1], flat.shape[-1], dtype=flat.dtype,
                   device=flat.device)
    pos = qt.reshape(qt.shape + (1,) * (flat.dim() - 1)) * (n - 1)
    return torch.where(pos - torch.floor(pos) <= 0.5, lo, hi)



@register_kernel("quantile")
def _quantile(x, q=0.5, axis=None, keepdim=False, interpolation="linear"):
    flat, keep = _to_last(x, axis)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = _nearest(torch.quantile, flat, qt, False) \
        if interpolation == "nearest" else \
        torch.quantile(flat, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        out = out.reshape(tuple(qt.shape) + tuple(keep))
    return out


@register_kernel("nanquantile")
def _nanquantile(x, q=0.5, axis=None, keepdim=False, interpolation="linear"):
    flat, keep = _to_last(x, axis)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = _nearest(torch.nanquantile, flat, qt, True) \
        if interpolation == "nearest" else \
        torch.nanquantile(flat, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        out = out.reshape(tuple(qt.shape) + tuple(keep))
    return out


@register_kernel("nanmedian")
def _nanmedian(x, axis=None, keepdim=False):
    flat, keep = _to_last(x, axis)
    out = torch.nanquantile(flat, 0.5, dim=-1)
    return out.reshape(keep) if keepdim else out


@register_kernel("kthvalue")
def _kthvalue(x, k=1, axis=-1, keepdim=False):
    idxs = torch.argsort(x, dim=axis, stable=True)
    pick = idxs.narrow(axis, int(k) - 1, 1)
    val = torch.gather(x, axis, pick)
    if not keepdim:
        val, pick = val.squeeze(axis), pick.squeeze(axis)
    return val, pick


@register_kernel("mode")
def _mode(x, axis=-1, keepdim=False):
    axis = axis % x.dim()
    moved = x.movedim(axis, -1)
    n = moved.shape[-1]
    flat = moved.reshape(-1, n)
    s = torch.sort(flat, dim=-1).values
    breaks = torch.ones_like(s, dtype=torch.int64)
    breaks[:, 1:] = (s[:, 1:] != s[:, :-1]).long()
    grp = torch.cumsum(breaks, dim=-1) - 1
    counts = torch.zeros_like(grp).scatter_add_(1, grp,
                                                torch.ones_like(grp))
    best = torch.argmax(counts, dim=-1, keepdim=True)
    first = torch.argmax((grp == best).long(), dim=-1, keepdim=True)
    vals = torch.gather(s, 1, first)
    eq = (flat == vals).long()
    idx = n - 1 - torch.argmax(eq.flip(-1), dim=-1)
    shape = moved.shape[:-1]
    vals, idx = vals.reshape(shape), idx.reshape(shape)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@register_kernel("count_nonzero")
def _count_nonzero(x, axis=None, keepdim=False):
    nz = x != 0
    if axis is None:
        out = nz.sum()
        return out.reshape([1] * x.dim()) if keepdim else out
    return nz.sum(dim=_dims(axis, x.dim()), keepdim=keepdim)


# -- math ---------------------------------------------------------------------

@register_kernel("logcumsumexp")
def _logcumsumexp(x, axis=None):
    if axis is None:
        return torch.logcumsumexp(x.reshape(-1), 0)
    return torch.logcumsumexp(x, axis)


@register_kernel("renorm")
def _renorm(x, p=2.0, axis=0, max_norm=1.0):
    moved = x.movedim(axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.linalg.vector_norm(flat, ord=p, dim=1)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
    return (flat * scale[:, None]).reshape(moved.shape).movedim(0, axis)


@register_kernel("diff")
def _diff(x, n=1, axis=-1):
    return torch.diff(x, n=int(n), dim=axis)


@register_kernel("heaviside")
def _heaviside(x, y):
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return torch.where(x < 0, torch.zeros_like(x),
                       torch.where(x > 0, torch.ones_like(x), y))


@register_kernel("copysign")
def _copysign(x, y):
    return torch.copysign(x, y)


@register_kernel("deg2rad")
def _deg2rad(x):
    return torch.deg2rad(x)


@register_kernel("rad2deg")
def _rad2deg(x):
    return torch.rad2deg(x)


@register_kernel("nan_to_num")
def _nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@register_kernel("ldexp")
def _ldexp(x, y):
    # x * 2**int(y); torch.ldexp's backward takes 2**y in integers
    return x * torch.pow(2.0, y.to(torch.int32).to(x.dtype))


@register_kernel("logit")
def _logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@register_kernel("signbit")
def _signbit(x):
    return torch.signbit(x)


@register_kernel("sgn")
def _sgn(x):
    # torch.sgn's backward of a real tensor is a ZeroTensor, which numpy
    # cannot read
    return torch.sgn(x) if x.is_complex() else torch.sign(x)


@register_kernel("isneginf")
def _isneginf(x):
    return torch.isneginf(x)


@register_kernel("isposinf")
def _isposinf(x):
    return torch.isposinf(x)


@register_kernel("isreal")
def _isreal(x):
    return torch.isreal(x)


@register_kernel("i0")
def _i0(x):
    return torch.special.i0(x)


@register_kernel("i0e")
def _i0e(x):
    return torch.special.i0e(x)


@register_kernel("i1")
def _i1(x):
    return torch.special.i1(x)


@register_kernel("i1e")
def _i1e(x):
    return torch.special.i1e(x)


@register_kernel("frexp")
def _frexp(x):
    m, e = torch.frexp(x)
    return m, e.long()


@register_kernel("gammaln")
def _gammaln(x):
    return torch.special.gammaln(x)


@register_kernel("gammainc")
def _gammainc(x, y):
    return torch.special.gammainc(x, y)


@register_kernel("gammaincc")
def _gammaincc(x, y):
    return torch.special.gammaincc(x, y)


@register_kernel("polygamma")
def _polygamma(x, n=1):
    return torch.special.polygamma(int(n), x)


@register_kernel("multigammaln")
def _multigammaln(x, p=1):
    p = int(p)
    i = torch.arange(p, dtype=x.dtype, device=x.device)
    return (torch.special.gammaln(x[..., None] - i / 2.0).sum(-1)
            + p * (p - 1) / 4.0 * math.log(math.pi))


@register_kernel("nextafter")
def _nextafter(x, y):
    return torch.nextafter(x, y)


@register_kernel("bitwise_left_shift")
def _bitwise_left_shift(x, y):
    return torch.bitwise_left_shift(x, y)


@register_kernel("bitwise_right_shift")
def _bitwise_right_shift(x, y):
    return torch.bitwise_right_shift(x, y)


@register_kernel("fmax")
def _fmax(x, y):
    return torch.fmax(x, y)


@register_kernel("fmin")
def _fmin(x, y):
    return torch.fmin(x, y)


@register_kernel("increment")
def _increment(x, value=1.0):
    return x + value


@register_kernel("fill")
def _fill(x, value=0.0):
    return torch.full_like(x, value)


# -- search / indexing --------------------------------------------------------

@register_kernel("take")
def _take(x, index, mode="raise"):
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = index.long()
    if mode == "wrap":
        idx = idx % n
    elif mode == "clip":
        idx = idx.clamp(0, n - 1)
    else:
        _not_captured("take")
        if bool(((idx < -n) | (idx >= n)).any()):
            raise IndexError(f"take(mode='raise'): index out of range for "
                             f"tensor with {n} elements")
        idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx]


@register_kernel("bucketize")
def _bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, out_int32=bool(out_int32),
                           right=bool(right))


@register_kernel("index_fill")
def _index_fill(x, index, axis=0, value=0.0):
    return torch.index_fill(x, axis, index.long().reshape(-1), value)


@register_kernel("masked_scatter")
def _masked_scatter(x, mask, value):
    m = torch.broadcast_to(mask, x.shape).reshape(-1).bool()
    order = torch.cumsum(m.long(), 0) - 1
    flat_v = value.reshape(-1)
    vals = flat_v[order.clamp(0, flat_v.numel() - 1)].to(x.dtype)
    return torch.where(m, vals, x.reshape(-1)).reshape(x.shape)


@register_kernel("index_sample")
def _index_sample(x, index):
    return torch.gather(x, 1, index.long())


@register_kernel("index_put")
def _index_put(x, indices, value, accumulate=False):
    idx = tuple(i.long() for i in indices)
    return torch.index_put(x, idx, value.to(x.dtype), bool(accumulate))


# -- manipulation -------------------------------------------------------------

@register_kernel("rot90")
def _rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), [int(a) for a in axes])


@register_kernel("unflatten")
def _unflatten(x, axis=0, shape=()):
    return torch.unflatten(x, axis, [int(s) for s in shape])


@register_kernel("expand_as")
def _expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@register_kernel("view_as")
def _view_as(x, other):
    return x.reshape(other.shape)


@register_kernel("reverse")
def _reverse(x, axis=()):
    ax = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(x, ax if ax else list(range(x.dim())))


@register_kernel("tensor_split")
def _tensor_split(x, num_or_indices=2, axis=0):
    arg = num_or_indices if isinstance(num_or_indices, int) \
        else [int(i) for i in num_or_indices]
    return tuple(torch.tensor_split(x, arg, dim=axis))


def _split_along(x, num_or_indices, axis):
    if isinstance(num_or_indices, int):
        if x.shape[axis] % num_or_indices:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {x.shape[axis]} into "
                             f"{num_or_indices}")
        return tuple(torch.tensor_split(x, num_or_indices, dim=axis))
    return tuple(torch.tensor_split(x, [int(i) for i in num_or_indices],
                                    dim=axis))


@register_kernel("hsplit")
def _hsplit(x, num_or_indices=2):
    return _split_along(x, num_or_indices, 1 if x.dim() > 1 else 0)


@register_kernel("vsplit")
def _vsplit(x, num_or_indices=2):
    return _split_along(x, num_or_indices, 0)


@register_kernel("dsplit")
def _dsplit(x, num_or_indices=2):
    return _split_along(x, num_or_indices, 2)


@register_kernel("as_strided")
def _as_strided(x, shape=(), stride=(), offset=0):
    """The strided view of ``x``'s row-major elements, as a copy."""
    return torch.as_strided(x.contiguous().reshape(-1),
                            [int(s) for s in shape],
                            [int(s) for s in stride], int(offset)).clone()


@register_kernel("tensor_unfold")
def _tensor_unfold(x, axis=0, size=1, step=1):
    return x.unfold(axis % x.dim(), int(size), int(step))


@register_kernel("fill_diagonal")
def _fill_diagonal(x, value=0.0, offset=0, wrap=False):
    out = x.clone()
    if x.dim() > 2:
        if offset != 0 or wrap:
            raise ValueError(
                "fill_diagonal: offset/wrap are unsupported for ndim > 2")
        if len(set(x.shape)) != 1:
            raise ValueError(
                "fill_diagonal: tensors with ndim > 2 must have all "
                f"dimensions equal, got {tuple(x.shape)}")
        idx = torch.arange(x.shape[0], device=x.device)
        out[(idx,) * x.dim()] = value
        return out
    rows_n, cols_n = x.shape[-2], x.shape[-1]
    n = max(min(rows_n, cols_n - offset), 0) if offset >= 0 else \
        max(min(rows_n + offset, cols_n), 0)
    if n == 0:
        return out
    ar = torch.arange(n, device=x.device)
    out[..., ar + max(-offset, 0), ar + max(offset, 0)] = value
    if wrap and rows_n > cols_n and offset == 0:
        start = cols_n + 1
        while start < rows_n:
            m = min(cols_n, rows_n - start)
            am = torch.arange(m, device=x.device)
            out[..., am + start, am] = value
            start += cols_n + 1
    return out


# -- the rest of the extended tranche ------------------------------------------

@register_kernel("vander")
def _vander(x, n=None, increasing=False):
    return torch.vander(x, N=None if n is None else int(n),
                        increasing=bool(increasing))


@register_kernel("trapezoid")
def _trapezoid(y, x=None, dx=1.0, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x=x, dim=int(axis))
    return torch.trapezoid(y, dx=float(dx), dim=int(axis))


@register_kernel("polar")
def _polar(abs, angle):
    return torch.polar(abs, angle)


@register_kernel("cdist")
def _cdist(x, y, p=2.0):
    diff = x[..., :, None, :] - y[..., None, :, :]
    if float(p) == 2.0:
        return (diff * diff).sum(-1).clamp(min=0.0).sqrt()
    return (diff.abs() ** float(p)).sum(-1) ** (1.0 / float(p))


@register_kernel("crop")
def _crop(x, shape=(), offsets=None):
    offs = [int(o) for o in offsets] if offsets is not None else \
        [0] * x.dim()
    idx = tuple(slice(o, None if int(s) == -1 else o + int(s))
                for o, s in zip(offs, shape))
    return x[idx]


def _list(xs):
    return [xs] if isinstance(xs, torch.Tensor) else list(xs)


@register_kernel("block_diag")
def _block_diag(xs):
    return torch.block_diag(*_list(xs))


@register_kernel("broadcast_tensors")
def _broadcast_tensors(xs):
    return tuple(torch.broadcast_tensors(*_list(xs)))


@register_kernel("column_stack")
def _column_stack(xs):
    return torch.column_stack(_list(xs))


@register_kernel("hstack")
def _hstack(xs):
    return torch.hstack(_list(xs))


@register_kernel("vstack")
def _vstack(xs):
    return torch.vstack(_list(xs))


@register_kernel("row_stack")
def _row_stack(xs):
    return torch.vstack(_list(xs))


@register_kernel("dstack")
def _dstack(xs):
    return torch.dstack(_list(xs))


@register_kernel("atleast_1d")
def _atleast_1d(x):
    return torch.atleast_1d(x)


@register_kernel("atleast_2d")
def _atleast_2d(x):
    return torch.atleast_2d(x)


@register_kernel("atleast_3d")
def _atleast_3d(x):
    return torch.atleast_3d(x)


@register_kernel("diag_embed")
def _diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """The last dim of ``x`` on the ``offset`` diagonal of two new dims,
    which land at ``dim1`` (rows) and ``dim2`` (columns) of the output."""
    n, off = x.shape[-1], int(offset)
    size = n + abs(off)
    out = x.new_zeros(x.shape[:-1] + (size, size))
    ar = torch.arange(n, device=x.device)
    out[..., ar + max(-off, 0), ar + max(off, 0)] = x
    nd = out.dim()
    d1, d2 = int(dim1) % nd, int(dim2) % nd
    if (d1, d2) != (nd - 2, nd - 1):
        out = out.movedim((nd - 2, nd - 1), (d1, d2))
    return out


@register_kernel("gather_tree")
def _gather_tree(ids, parents):
    """Beam-search backtrace: ids / parents ``[T, B, beam]`` -> the full
    sequences re-threaded through the parent pointers (at step t the beam
    emits ``ids[t][beams]``, then descends through ``parents[t][beams]``)."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        idx = beams.long()
        toks[t] = torch.gather(ids[t], -1, idx)
        beams = torch.gather(parents[t], -1, idx)
    return torch.stack(toks)
