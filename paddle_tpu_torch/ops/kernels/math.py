"""Math ops: elementwise unary and binary, reductions, linalg.

Counterparts of ``paddle_tpu/ops/kernels/math.py``: ``_UNARY`` / ``_BINARY``
(:16-56), ``scale`` ... ``equal_all`` (:59-95), the reductions (:98-206)
and linalg (:209-301). Each is one torch call or a short composite with
the reference's semantics: ``round`` halves to even, ``remainder`` / ``mod``
take the divisor's sign and ``fmod`` the dividend's, ``floor_divide``
floors, ``median`` averages the two middle values, ``lerp`` is ``x + w (y
- x)``, ``cummax`` / ``cummin`` return the values only. Products stay
``torch.matmul`` / ``torch.einsum`` and decompositions ``torch.linalg``,
as the reference's stay XLA's. A Python scalar operand of a binary op
becomes a 0-d tensor on the other operand's device (float32 for a float,
int64 for an int): it does not widen the tensor's dtype. Integer results
that the reference gives as int32 are int64 here (``sum`` of bools,
``cumsum`` of ints).
"""

from __future__ import annotations

import torch

from ...core.device import dtype_of
from ..dispatcher import register_kernel


def _t(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor beside ``like`` (a Python scalar as a 0-d
    tensor, which torch's promotion treats as weak)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=like.device)


def _pair(fn):
    def op(x, y):
        if not isinstance(x, torch.Tensor):
            x = _t(x, y)
        return fn(x, _t(y, x))
    return op


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _reciprocal(x):
    return 1.0 / x


def _frac(x):
    return x - torch.trunc(x)


UNARY = {
    "abs": torch.abs, "exp": torch.exp, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "expm1": torch.expm1, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "asinh": torch.asinh,
    "acosh": torch.acosh, "atanh": torch.atanh, "floor": torch.floor,
    "ceil": torch.ceil, "round": torch.round, "trunc": torch.trunc,
    "sign": torch.sign, "square": torch.square, "reciprocal": _reciprocal,
    "neg": torch.neg, "erf": torch.erf, "erfinv": torch.erfinv,
    "lgamma": torch.lgamma, "digamma": torch.digamma, "frac": _frac,
    "conj": torch.conj_physical, "angle": torch.angle, "real": torch.real,
    "imag": _imag, "isnan": torch.isnan, "isinf": torch.isinf,
    "isfinite": torch.isfinite, "logical_not": torch.logical_not,
    "bitwise_not": torch.bitwise_not,
}
for _name, _fn in UNARY.items():
    register_kernel(_name)(lambda x, _fn=_fn: _fn(x))

BINARY = {
    "add": torch.add, "subtract": torch.subtract,
    "multiply": torch.multiply, "divide": torch.true_divide,
    "pow": torch.pow, "maximum": torch.maximum, "minimum": torch.minimum,
    "remainder": torch.remainder, "mod": torch.remainder,
    "fmod": torch.fmod, "floor_divide": torch.floor_divide,
    "atan2": torch.atan2, "logaddexp": torch.logaddexp,
    "hypot": torch.hypot, "gcd": torch.gcd, "lcm": torch.lcm,
    "equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
    "less_equal": torch.le, "greater_than": torch.gt,
    "greater_equal": torch.ge, "logical_and": torch.logical_and,
    "logical_or": torch.logical_or, "logical_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
}
for _name, _fn in BINARY.items():
    register_kernel(_name)(_pair(_fn))


@register_kernel("scale")
def _scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@register_kernel("clip")
def _clip(x, min=None, max=None):
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


@register_kernel("lerp")
def _lerp(x, y, weight):
    return x + weight * (y - x)


@register_kernel("addmm")
def _addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@register_kernel("allclose")
def _allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, _t(y, x), rtol, atol, equal_nan).all()


@register_kernel("isclose")
def _isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, _t(y, x), rtol, atol, equal_nan)


@register_kernel("equal_all")
def _equal_all(x, y):
    y = _t(y, x)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return (x == y).all()


# -- reductions ---------------------------------------------------------------

def _dims(x, axis):
    """``axis`` as a tuple of dims; None or () is every dim."""
    if axis is None or axis == () or axis == []:
        return tuple(range(x.dim()))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    return (int(axis),) if isinstance(axis, int) else tuple(int(a)
                                                           for a in axis)


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


@register_kernel("sum")
def _sum(x, axis=None, dtype=None, keepdim=False):
    dtype = None if dtype is None else dtype_of(dtype)
    if axis is None and not keepdim:
        return x.sum(dtype=dtype)
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dtype)


@register_kernel("mean")
def _mean(x, axis=None, keepdim=False):
    """The mean (of an integer tensor: in float32). With no axis, the
    mean of every element by ``Tensor.mean()``, as the Llama loss has
    always taken it."""
    x = _float(x)
    if axis is None and not keepdim:
        return x.mean()
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("max")
def _max(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("min")
def _min(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("amax")
def _amax(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("amin")
def _amin(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("prod")
def _prod(x, axis=None, keepdim=False, dtype=None):
    if dtype is not None:
        x = x.to(dtype_of(dtype))
    for d in sorted((d % max(x.dim(), 1) for d in _dims(x, axis)),
                    reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


@register_kernel("any")
def _any(x, axis=None, keepdim=False):
    return torch.any(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("all")
def _all(x, axis=None, keepdim=False):
    return torch.all(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("logsumexp")
def _logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("std")
def _std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_dims(x, axis), correction=int(bool(unbiased)),
                     keepdim=keepdim)


@register_kernel("var")
def _var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_dims(x, axis), correction=int(bool(unbiased)),
                     keepdim=keepdim)


@register_kernel("median")
def _median(x, axis=None, keepdim=False):
    """The mean of the two middle values for an even count (torch's
    ``median`` takes the lower one): the 0.5 quantile over the axes,
    moved last and flattened."""
    dims = sorted(d % max(x.dim(), 1) for d in _dims(x, axis))
    rest = [d for d in range(x.dim()) if d not in dims]
    flat = _float(x).permute(rest + dims).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = torch.quantile(flat, 0.5, dim=-1)
    if keepdim:
        out = out.reshape([1 if d in dims else n
                           for d, n in enumerate(x.shape)])
    return out


@register_kernel("nanmean")
def _nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("nansum")
def _nansum(x, axis=None, keepdim=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim)


@register_kernel("cumsum")
def _cumsum(x, axis=None):
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, int(axis))


@register_kernel("cumprod")
def _cumprod(x, dim=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, int(dim))


@register_kernel("cummax")
def _cummax(x, axis=-1):
    return torch.cummax(x, int(axis)).values


@register_kernel("cummin")
def _cummin(x, axis=-1):
    return torch.cummin(x, int(axis)).values


# -- linalg -------------------------------------------------------------------

@register_kernel("matmul")
def _matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y``, each operand of two or more dims transposed in its last
    two first where asked (a 1-D operand as it is)."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register_kernel("dot")
def _dot(x, y):
    return torch.sum(x * y, dim=-1)


@register_kernel("outer")
def _outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@register_kernel("cross")
def _cross(x, y, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


@register_kernel("bmm")
def _bmm(x, y):
    return torch.matmul(x, y)


@register_kernel("mv")
def _mv(x, vec):
    return torch.matmul(x, vec)


@register_kernel("t")
def _t_op(x):
    return x.permute(*reversed(range(x.dim())))


@register_kernel("norm")
def _norm(x, p=2.0, axis=None, keepdim=False):
    """``p`` inf / -inf: the max / min of ``|x|``; no axis: the vector
    norm of every element; one axis: a vector norm; two: a matrix norm
    (``p`` 2 its largest singular value, as ``jnp.linalg.norm``)."""
    if p in (float("inf"), float("-inf")):
        red = torch.amax if p > 0 else torch.amin
        return red(x.abs(), dim=_dims(x, axis), keepdim=keepdim)
    if axis is None:
        return torch.linalg.vector_norm(x.reshape(-1), ord=p, dim=0,
                                        keepdim=keepdim)
    dims = _dims(x, axis)
    if len(dims) == 2:
        return torch.linalg.matrix_norm(x, ord=p, dim=dims, keepdim=keepdim)
    return torch.linalg.vector_norm(x, ord=p, dim=dims, keepdim=keepdim)


@register_kernel("einsum_impl")
def _einsum_impl(operands, equation=""):
    return torch.einsum(equation, *operands)


@register_kernel("triangular_solve")
def _triangular_solve(x, y, upper=True, transpose=False,
                      unitriangular=False):
    """X with ``A X = y`` (``A^T X = y`` when ``transpose``), A = x read
    from its upper or lower triangle."""
    a = x
    if transpose:
        a, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, y, upper=upper, left=True,
                                         unitriangular=unitriangular)


@register_kernel("cholesky")
def _cholesky(x, upper=False):
    low = torch.linalg.cholesky(x)
    return low.transpose(-1, -2) if upper else low


@register_kernel("inverse")
def _inverse(x):
    return torch.linalg.inv(x)


@register_kernel("matrix_transpose")
def _matrix_transpose(x):
    return x.transpose(-1, -2)


@register_kernel("trace")
def _trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@register_kernel("kron")
def _kron(x, y):
    return torch.kron(x, y)


@register_kernel("diagonal")
def _diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)
