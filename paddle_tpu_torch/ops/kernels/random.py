"""Random ops.

Counterparts of ``paddle_tpu/ops/kernels/random.py`` (less ``dropout``,
in ``nn.py``), the random ops of ``extra_misc.py`` (``binomial``,
``dirichlet``, ``standard_gamma``, ``truncated_gaussian_random``,
``fused_dropout_add``), ``rrelu`` (``extra_nn.py``), ``shuffle_batch`` and
``uniform_random_batch_size_like`` (``compat_tranche.py``) and
``pca_lowrank`` (``tensor_api_ext.py``).

The reference splits a threefry key per draw; the port's ops draw from a
``torch.Generator``: the one passed as ``generator=`` (not part of the
registry's schema), else the port's generator for the output's device
(``core.generator.default_generator``, reseeded by ``paddle.seed``),
never torch's global one. Under step capture that generator is registered
with the graph, so a replay draws anew and advances it as the eager draw
does. The bits cannot match JAX's; the ops match the reference by shape,
dtype, support and moments. An op with no tensor argument makes its
output on ``set_device``'s device (the card by default) in the default
float dtype; integer outputs are int64, where the reference gives int32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...core import dtype as dtype_mod
from ...core.device import layer_device
from ...core.generator import generator_for
from ..dispatcher import register_kernel
from .nn import _dropout

Gen = Optional[torch.Generator]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, int) else \
        tuple(int(s) for s in shape)


def _float(dtype) -> torch.dtype:
    return dtype_mod.get_default_dtype() if dtype is None \
        else dtype_mod.dtype_of(dtype)


def _new(shape, dtype, generator: Gen):
    dev = layer_device()
    return torch.empty(_shape(shape), dtype=dtype, device=dev), \
        generator_for(dev, generator)


@register_kernel("uniform")
def uniform(shape=(), dtype=None, min=0.0, max=1.0, generator: Gen = None):
    out, g = _new(shape, _float(dtype), generator)
    return out.uniform_(float(min), float(max), generator=g)


@register_kernel("rand")
def rand(shape=(), dtype=None, generator: Gen = None):
    return uniform(shape, dtype, 0.0, 1.0, generator)


@register_kernel("gaussian")
def gaussian(shape=(), mean=0.0, std=1.0, dtype=None, generator: Gen = None):
    out, g = _new(shape, _float(dtype), generator)
    return out.normal_(float(mean), float(std), generator=g)


@register_kernel("randn")
def randn(shape=(), dtype=None, generator: Gen = None):
    return gaussian(shape, 0.0, 1.0, dtype, generator)


@register_kernel("randint")
def randint(low=0, high=None, shape=(), dtype=None, generator: Gen = None):
    if high is None:
        low, high = 0, low
    dt = torch.int64 if dtype is None else dtype_mod.dtype_of(dtype)
    dev = layer_device()
    return torch.randint(int(low), int(high), _shape(shape), dtype=dt,
                         device=dev, generator=generator_for(dev, generator))


@register_kernel("randperm")
def randperm(n, dtype=None, generator: Gen = None):
    dt = torch.int64 if dtype is None else dtype_mod.dtype_of(dtype)
    dev = layer_device()
    return torch.randperm(int(n), dtype=dt, device=dev,
                          generator=generator_for(dev, generator))


@register_kernel("truncated_gaussian_random")
def truncated_gaussian_random(shape=(), mean=0.0, std=1.0, a=-2.0, b=2.0,
                              dtype="float32", generator: Gen = None):
    """normal(mean, std) cut to ``[mean + a std, mean + b std]``, by the
    inverse CDF of a uniform draw between the cut's CDF values."""
    u, g = _new(shape, torch.float32, generator)
    lo, hi = (0.5 * (1.0 + math.erf(float(v) / math.sqrt(2.0)))
              for v in (a, b))
    u.uniform_(lo, hi, generator=g)
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    z = z.clamp_(float(a), float(b))
    return (z * float(std) + float(mean)).to(dtype_mod.dtype_of(dtype))


def _like(x, generator: Gen):
    return torch.empty_like(x), generator_for(x.device, generator)


@register_kernel("normal_like")
def normal_like(x, mean=0.0, std=1.0, generator: Gen = None):
    out, g = _like(x, generator)
    return out.normal_(float(mean), float(std), generator=g)


@register_kernel("uniform_like")
def uniform_like(x, min=-1.0, max=1.0, generator: Gen = None):
    out, g = _like(x, generator)
    return out.uniform_(float(min), float(max), generator=g)


@register_kernel("exponential")
def exponential(x, lam=1.0, generator: Gen = None):
    out, g = _like(x, generator)
    return out.exponential_(float(lam), generator=g)


@register_kernel("cauchy_like")
def cauchy_like(x, loc=0.0, scale=1.0, generator: Gen = None):
    out, g = _like(x, generator)
    return out.cauchy_(float(loc), float(scale), generator=g)


@register_kernel("geometric_like")
def geometric_like(x, probs=0.5, generator: Gen = None):
    """``log(u) / log1p(-probs)``: continuous positive values, not trial
    counts, as the reference (``probs`` clamped to ``[1e-7, 1 - 1e-7]``)."""
    g = generator_for(x.device, generator)
    u = torch.rand(x.shape, generator=g, device=x.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    p = min(max(float(probs), 1e-7), 1.0 - 1e-7)
    return (torch.log(u) / math.log1p(-p)).to(x.dtype)


@register_kernel("bernoulli")
def bernoulli(x, generator: Gen = None):
    g = generator_for(x.device, generator)
    return torch.bernoulli(x, generator=g)


@register_kernel("multinomial")
def multinomial(x, num_samples=1, replacement=False, generator: Gen = None):
    """``num_samples`` category indices per row of the (unnormalized)
    weights ``x[..., C]``: with replacement by the inverse CDF of uniform
    draws, without by the Gumbel top-k trick (the reference's); neither
    reads the weights on the host."""
    g = generator_for(x.device, generator)
    n = int(num_samples)
    flat = x.reshape(-1, x.shape[-1]).float()
    shape = (flat.shape[0], n if replacement else flat.shape[1])
    u = torch.rand(shape, generator=g, device=x.device)
    if replacement:
        cdf = torch.cumsum(flat, dim=-1)
        cdf = cdf / cdf[:, -1:]
        out = torch.searchsorted(cdf, u, right=True)
        out = out.clamp_(max=flat.shape[1] - 1)
    else:
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        out = torch.topk(torch.log(flat) + gumbel, n, dim=-1).indices
    return out.reshape(tuple(x.shape[:-1]) + (n,))


@register_kernel("poisson")
def poisson(x, generator: Gen = None):
    g = generator_for(x.device, generator)
    return torch.poisson(x.float(), generator=g).to(x.dtype)


@register_kernel("shuffle")
def shuffle(x, axis=0, generator: Gen = None):
    g = generator_for(x.device, generator)
    axis = int(axis) % x.dim()
    idx = torch.randperm(x.shape[axis], generator=g, device=x.device)
    return torch.index_select(x, axis, idx)


@register_kernel("shuffle_batch")
def shuffle_batch(x, generator: Gen = None):
    """``(x[perm], perm)`` for a random permutation of the batch."""
    g = generator_for(x.device, generator)
    idx = torch.randperm(x.shape[0], generator=g, device=x.device)
    return x[idx], idx


@register_kernel("uniform_random_batch_size_like")
def uniform_random_batch_size_like(input, shape=(), min=-1.0, max=1.0,
                                   dtype=None, input_dim_idx=0,
                                   output_dim_idx=0, generator: Gen = None):
    shape = list(_shape(shape))
    if not shape or output_dim_idx >= len(shape):
        raise ValueError(
            "uniform_random_batch_size_like: `shape` is required and must "
            f"cover output_dim_idx={output_dim_idx} (got {shape})")
    shape[output_dim_idx] = input.shape[input_dim_idx]
    dt = torch.float32 if dtype is None else dtype_mod.dtype_of(dtype)
    g = generator_for(input.device, generator)
    return torch.empty(shape, dtype=dt, device=input.device).uniform_(
        float(min), float(max), generator=g)


@register_kernel("binomial")
def binomial(count, prob, generator: Gen = None):
    g = generator_for(count.device, generator)
    return torch.binomial(count.float(), prob.float(), generator=g).long()


@register_kernel("dirichlet")
def dirichlet(alpha, generator: Gen = None):
    g = generator_for(alpha.device, generator)
    return torch._sample_dirichlet(alpha.float(), generator=g).to(
        alpha.dtype)


@register_kernel("standard_gamma")
def standard_gamma(x, generator: Gen = None):
    g = generator_for(x.device, generator)
    return torch._standard_gamma(x.float(), generator=g).to(x.dtype)


@register_kernel("fused_dropout_add")
def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      generator: Gen = None):
    """``dropout(x) + y``; outside training (or p 0) ``x + y``."""
    if not training or float(p) == 0.0:
        return x + y
    return _dropout(x, float(p), True, mode, generator) + y


@register_kernel("rrelu")
def rrelu(x, lower=0.125, upper=0.333333, is_test=False,
          generator: Gen = None):
    """Leaky ReLU whose negative slope is drawn per element from
    ``U(lower, upper)`` (``is_test``: their mean)."""
    if is_test:
        return torch.where(x >= 0, x, x * ((lower + upper) / 2.0))
    g = generator_for(x.device, generator)
    slope = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    slope.uniform_(float(lower), float(upper), generator=g)
    return torch.where(x >= 0, x, x * slope.to(x.dtype))


@register_kernel("pca_lowrank")
def pca_lowrank(x, q=None, center=True, niter=2, generator: Gen = None):
    """Randomized PCA (a Halko-Martinsson-Tropp range finder with power
    iterations) -> ``(U, S, V)``; differentiable through qr and svd."""
    m, n = x.shape[-2], x.shape[-1]
    q = min(6, m, n) if q is None else int(q)
    if not 0 <= q <= min(m, n):
        raise ValueError(f"q={q} must be in [0, {min(m, n)}]")
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
    g = generator_for(x.device, generator)
    omega = torch.empty(tuple(x.shape[:-2]) + (n, q), dtype=x.dtype,
                        device=x.device).normal_(generator=g)
    qmat = torch.linalg.qr(x @ omega).Q
    for _ in range(int(niter)):
        zq = torch.linalg.qr(x.transpose(-2, -1) @ qmat).Q
        qmat = torch.linalg.qr(x @ zq).Q
    u_b, s, vh = torch.linalg.svd(qmat.transpose(-2, -1) @ x,
                                  full_matrices=False)
    return qmat @ u_b, s, vh.transpose(-2, -1)

