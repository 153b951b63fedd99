"""Round-2 tranche ops of ``paddle_tpu/ops/kernels/extra_misc.py``:
``top_p_sampling`` (:468, ``ops.yaml:619``), the sampling op the serving
slice brings, and the linalg and fft extras (:498-565,
``ops.yaml:622-626``): ``matrix_rank`` (the version the reference's
registry holds: the tolerance from ``finfo(x.dtype)``, a given ``tol``
broadcast over the batch), ``lu_unpack`` (``P, L, U`` from packed LU and
1-based pivots, whatever the two flags say, as the reference), and the
``fft_c2c`` / ``fft_r2c`` / ``fft_c2r`` kernels over ``torch.fft``
(``fft_c2r`` reads its half spectrum as pocketfft does:
``linalg_fft.hermitian_half``).

``top_p_sampling`` is ``key: true`` in the reference; here its draw comes
from ``generator=``, by default the port's generator for the logits'
device (``core.generator``). The bits cannot match threefry's: the op
matches the reference by support, shape, dtype and the top-p cut.

The op forms that run on one device (``ops.yaml:577-620``, the
reference's :59-485): the eleven functional optimizer updates (``sgd_op``
to ``rprop_op``: one tensor's update in plain torch, float32 arithmetic,
``master_param`` updated in its place and returned last, the ``beta*_pow``
outputs advanced; ``skip_update``, ``lazy_mode`` and ``always_adapt`` are
accepted and unused, as in the reference), amp's
``check_finite_and_unscale_op`` and ``update_loss_scaling_op`` (the
counters and the zeroing of ``xs`` on the card, never read on the host),
the local forms of ``c_identity``, ``c_concat`` and ``c_embedding``, the
fused ops (``gelu`` is the tanh form, JAX's default) and
``memory_efficient_attention``, the composite attention
(``nn.py:_sdpa``; dropout from ``generator=``, the port's generator by
default).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...core.generator import generator_for
from ..dispatcher import register_kernel
from .nn import _sdpa


@register_kernel("top_p_sampling")
def top_p_sampling(x: torch.Tensor, ps: torch.Tensor, threshold=None,
                   generator: Optional[torch.Generator] = None):
    """Per-row nucleus sampling: x ``[B, V]`` logits, ps ``[B]`` each row's
    p. Keeps the smallest set of the highest logits whose probability
    reaches p (at least one), draws one id a row from it. Returns
    ``(ids [B, 1] int64, scores [B, 1] float32)``, the score being the
    drawn id's softmax probability over all the logits. ``threshold`` is
    accepted and unused, as in the reference."""
    logits = x.float()
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    cut_idx = (cum < ps.float().reshape(-1, 1)).sum(dim=-1, keepdim=True)
    # the reference's gather clamps an index past the end (p = 1.0 with a
    # cumulative sum that rounds below it)
    cutoff = torch.gather(sorted_l, -1,
                          cut_idx.clamp(max=logits.shape[-1] - 1))
    filt = logits.masked_fill(logits < cutoff, float("-inf"))
    g = generator_for(logits.device, generator)
    ids = torch.multinomial(torch.softmax(filt, dim=-1), 1, generator=g)
    scores = torch.gather(torch.softmax(logits, dim=-1), -1, ids)
    return ids.to(torch.int64), scores


# -- linalg extras --------------------------------------------------------------

@register_kernel("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False):
    if hermitian:
        s = torch.linalg.eigvalsh(x).abs()
    else:
        from .linalg_fft import svdvals_on
        s = svdvals_on(x)
    if tol is None:
        t = s.max(dim=-1, keepdim=True).values * max(x.shape[-2:]) * \
            torch.finfo(x.dtype).eps
    else:
        t = torch.as_tensor(tol, device=s.device, dtype=s.dtype)
        while t.dim() < s.dim():
            t = t[..., None]
    return (s > t).sum(dim=-1).to(torch.int32)


@register_kernel("lu_unpack")
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    """x: packed LU ``[.., M, N]``; y: 1-based pivots ``[.., min(M, N)]``.
    Returns ``(P, L, U)`` with ``A = P @ L @ U``."""
    P, L, U = torch.lu_unpack(x, y.to(torch.int32))
    return P, L, U


# -- fft kernels ------------------------------------------------------------------

def _axes(axes):
    return tuple(int(a) for a in ([axes] if isinstance(axes, int) else axes))


@register_kernel("fft_c2c")
def fft_c2c(x, axes=(-1,), normalization="backward", forward=True):
    fn = torch.fft.fftn if forward else torch.fft.ifftn
    return fn(x, dim=_axes(axes), norm=normalization)


@register_kernel("fft_r2c")
def fft_r2c(x, axes=(-1,), normalization="backward", forward=True,
            onesided=True):
    if onesided:
        return torch.fft.rfftn(x, dim=_axes(axes), norm=normalization)
    return torch.fft.fftn(x.to(torch.complex64), dim=_axes(axes),
                          norm=normalization)


@register_kernel("fft_c2r")
def fft_c2r(x, axes=(-1,), normalization="backward", forward=False,
            last_dim_size=0):
    from .linalg_fft import hermitian_half
    dims = _axes(axes)
    n = int(last_dim_size)
    s = None if not n else \
        tuple(x.shape[d] for d in dims[:-1]) + (n,)
    x, s = hermitian_half(x, s, dims)
    return torch.fft.irfftn(x, s=s, dim=dims, norm=normalization)


# -- functional optimizer ops -------------------------------------------------

def _master(param, master_param):
    return (master_param if master_param is not None else param).float()


def _outs(new_p, param, master_param, *state):
    """``(param in its dtype, *state[, master])``."""
    outs = [new_p.to(param.dtype), *state]
    if master_param is not None:
        outs.append(new_p)
    return tuple(outs)


@register_kernel("sgd_op")
def sgd_op(param, learning_rate, grad, master_param=None,
           multi_precision=False):
    p = master_param if master_param is not None else param
    new_p = p - learning_rate.to(p.dtype) * grad.to(p.dtype)
    if master_param is not None:
        return new_p.to(param.dtype), new_p
    return new_p


@register_kernel("momentum_op")
def momentum_op(param, grad, velocity, learning_rate, master_param=None,
                mu=0.9, use_nesterov=False, regularization_method="",
                regularization_coeff=0.0, multi_precision=False,
                rescale_grad=1.0):
    p = _master(param, master_param)
    g = grad.float() * float(rescale_grad)
    if regularization_method == "l2_decay":
        g = g + float(regularization_coeff) * p
    v = float(mu) * velocity.float() + g
    lr = learning_rate.float()
    new_p = p - (g + float(mu) * v) * lr if use_nesterov else p - v * lr
    return _outs(new_p, param, master_param, v)


def _adam_core(param, grad, lr, m1, m2, b1p, b2p, master_param, beta1,
               beta2, epsilon):
    p = _master(param, master_param)
    g = grad.float()
    m1n = beta1 * m1.float() + (1 - beta1) * g
    m2n = beta2 * m2.float() + (1 - beta2) * g * g
    b1n = b1p.float() * beta1
    b2n = b2p.float() * beta2
    lr_t = lr.float() * torch.sqrt(1 - b2n) / (1 - b1n)
    new_p = p - lr_t * m1n / (torch.sqrt(m2n) + epsilon)
    return new_p, m1n, m2n, b1n, b2n


@register_kernel("adam_op")
def adam_op(param, grad, learning_rate, moment1, moment2, beta1_pow,
            beta2_pow, master_param=None, skip_update=None, beta1=0.9,
            beta2=0.999, epsilon=1e-8, lazy_mode=False,
            multi_precision=False):
    new_p, *state = _adam_core(param, grad, learning_rate, moment1, moment2,
                               beta1_pow, beta2_pow, master_param,
                               float(beta1), float(beta2), float(epsilon))
    return _outs(new_p, param, master_param, *state)


@register_kernel("adamw_op")
def adamw_op(param, grad, learning_rate, moment1, moment2, beta1_pow,
             beta2_pow, master_param=None, skip_update=None, beta1=0.9,
             beta2=0.999, epsilon=1e-8, lr_ratio=1.0, coeff=0.01,
             with_decay=True, multi_precision=False):
    """The decay ``p * (1 - lr * coeff)`` first, then Adam from the decayed
    value (rounded to the param's dtype where there is no master, as the
    reference)."""
    p0 = _master(param, master_param)
    lr = learning_rate.float() * float(lr_ratio)
    if with_decay:
        p0 = p0 * (1.0 - lr * float(coeff))
    new_p, *state = _adam_core(
        p0.to(param.dtype), grad, lr, moment1, moment2, beta1_pow,
        beta2_pow, p0 if master_param is not None else None, float(beta1),
        float(beta2), float(epsilon))
    return _outs(new_p, param, master_param, *state)


@register_kernel("adagrad_op")
def adagrad_op(param, grad, moment, learning_rate, master_param=None,
               epsilon=1e-6, multi_precision=False):
    p, g = _master(param, master_param), grad.float()
    m = moment.float() + g * g
    new_p = p - learning_rate.float() * g / (torch.sqrt(m) + float(epsilon))
    return _outs(new_p, param, master_param, m)


@register_kernel("adadelta_op")
def adadelta_op(param, grad, avg_squared_grad, avg_squared_update,
                learning_rate=None, master_param=None, rho=0.95,
                epsilon=1e-6, multi_precision=False):
    p, g = _master(param, master_param), grad.float()
    rho, eps = float(rho), float(epsilon)
    asg = rho * avg_squared_grad.float() + (1 - rho) * g * g
    upd = (torch.sqrt(avg_squared_update.float() + eps)
           / torch.sqrt(asg + eps)) * g
    asu = rho * avg_squared_update.float() + (1 - rho) * upd * upd
    lr = learning_rate.float() if learning_rate is not None else 1.0
    return _outs(p - lr * upd, param, master_param, asg, asu)


@register_kernel("adamax_op")
def adamax_op(param, grad, learning_rate, moment, inf_norm, beta1_pow,
              master_param=None, beta1=0.9, beta2=0.999, epsilon=1e-8,
              multi_precision=False):
    p, g = _master(param, master_param), grad.float()
    m = float(beta1) * moment.float() + (1 - float(beta1)) * g
    n = torch.maximum(float(beta2) * inf_norm.float(), g.abs())
    lr = learning_rate.float() / (1 - beta1_pow.float())
    new_p = p - lr * m / (n + float(epsilon))
    return _outs(new_p, param, master_param, m, n)


@register_kernel("rmsprop_op")
def rmsprop_op(param, mean_square, grad, moment, learning_rate,
               mean_grad=None, master_param=None, epsilon=1e-10, decay=0.9,
               momentum=0.0, centered=False, multi_precision=False):
    """Returns ``(param, moment, mean_square[, mean_grad][, master])``."""
    p, g = _master(param, master_param), grad.float()
    d = float(decay)
    ms = d * mean_square.float() + (1 - d) * g * g
    state = []
    if centered and mean_grad is not None:
        mg = d * mean_grad.float() + (1 - d) * g
        denom = torch.sqrt(ms - mg * mg + float(epsilon))
        state = [mg]
    else:
        denom = torch.sqrt(ms + float(epsilon))
    mom = float(momentum) * moment.float() + learning_rate.float() * g / denom
    return _outs(p - mom, param, master_param, mom, ms, *state)


@register_kernel("lamb_op")
def lamb_op(param, grad, learning_rate, moment1, moment2, beta1_pow,
            beta2_pow, master_param=None, weight_decay=0.01, beta1=0.9,
            beta2=0.999, epsilon=1e-6, always_adapt=False,
            multi_precision=False):
    p, g = _master(param, master_param), grad.float()
    b1, b2 = float(beta1), float(beta2)
    m1 = b1 * moment1.float() + (1 - b1) * g
    m2 = b2 * moment2.float() + (1 - b2) * g * g
    b1n = beta1_pow.float() * b1
    b2n = beta2_pow.float() * b2
    r = (m1 / (1 - b1n)) / (torch.sqrt(m2 / (1 - b2n)) + float(epsilon)) \
        + float(weight_decay) * p
    p_norm = torch.sqrt((p * p).sum())
    r_norm = torch.sqrt((r * r).sum())
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    new_p = p - learning_rate.float() * trust * r
    return _outs(new_p, param, master_param, m1, m2, b1n, b2n)


@register_kernel("asgd_op")
def asgd_op(param, grad, learning_rate, d, y, n, master_param=None,
            multi_precision=False):
    p, g = _master(param, master_param), grad.float()
    dn = d.float() - y.float() + g
    new_p = p - learning_rate.float() * dn / n.float().clamp(min=1.0)
    return _outs(new_p, param, master_param, dn, g)


@register_kernel("rprop_op")
def rprop_op(param, grad, prev, learning_rate, master_param=None,
             learning_rate_range=(1e-6, 50.0), etas=(0.5, 1.2),
             multi_precision=False):
    """Each element's step grows by ``etas[1]`` where the gradient kept
    its sign, shrinks by ``etas[0]`` where it flipped (and that gradient
    is zeroed), clipped to ``learning_rate_range``. Returns ``(param,
    prev grad, learning rate[, master])``."""
    p, g = _master(param, master_param), grad.float()
    sign = torch.sign(g * prev.float())
    factor = torch.where(sign > 0, float(etas[1]),
                         torch.where(sign < 0, float(etas[0]), 1.0))
    lr_new = (learning_rate.float() * factor).clamp(
        float(learning_rate_range[0]), float(learning_rate_range[1]))
    g_eff = torch.where(sign < 0, 0.0, g)
    new_p = p - torch.sign(g_eff) * lr_new
    return _outs(new_p, param, master_param, g_eff, lr_new)


# -- amp ops ------------------------------------------------------------------

@register_kernel("check_finite_and_unscale_op")
def check_finite_and_unscale_op(xs, scale):
    """``(*xs / scale, found_inf)``, ``found_inf`` a 0-d bool on the card."""
    inv = 1.0 / scale.float()
    outs = [x * inv.to(x.dtype) for x in xs]
    if not outs:
        return (torch.zeros((), dtype=torch.bool, device=scale.device),)
    finite = torch.stack([torch.isfinite(o).all() for o in outs]).all()
    return tuple(outs) + (~finite,)


@register_kernel("update_loss_scaling_op")
def update_loss_scaling_op(xs, found_infinite, prev_loss_scaling,
                           in_good_steps, in_bad_steps,
                           incr_every_n_steps=1000,
                           decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                           decr_ratio=0.5, stop_update=False):
    """The dynamic loss scale's step: ``xs`` zeroed when ``found_infinite``,
    the good / bad step counters (int32) and the scale advanced by the
    reference's rules. Returns ``(*xs, scale, good, bad)``."""
    found = found_infinite.bool()
    good = in_good_steps.to(torch.int32)
    bad = in_bad_steps.to(torch.int32)
    scale = prev_loss_scaling.float()
    good_n = torch.where(found, 0, good + 1).to(torch.int32)
    bad_n = torch.where(found, bad + 1, 0).to(torch.int32)
    up = good_n >= incr_every_n_steps
    scale_up = torch.where(up, scale * float(incr_ratio), scale)
    good_n = torch.where(up, 0, good_n).to(torch.int32)
    dn = bad_n >= decr_every_n_nan_or_inf
    scale_dn = torch.where(dn, (scale * float(decr_ratio)).clamp(min=1.0),
                           scale_up)
    bad_n = torch.where(dn, 0, bad_n).to(torch.int32)
    new_scale = scale if stop_update else scale_dn
    outs = tuple(torch.where(found, torch.zeros_like(x), x) for x in xs)
    return outs + (new_scale.to(prev_loss_scaling.dtype), good_n, bad_n)


# -- the c_* ops in their local forms -----------------------------------------

@register_kernel("c_identity")
def c_identity(x, ring_id=0, use_calc_stream=True, use_model_parallel=True):
    return x


@register_kernel("c_concat")
def c_concat(x, rank=0, nranks=1, ring_id=0):
    """One process holds every shard: the concatenation is ``x``."""
    return x


@register_kernel("c_embedding")
def c_embedding(table, ids, start_index=0, vocab_size=-1):
    """The vocab-parallel embedding's local lookup: ids outside
    ``[start_index, start_index + rows)`` give zero rows."""
    n = table.shape[0]
    local = ids.long() - int(start_index)
    inside = (local >= 0) & (local < n)
    out = F.embedding(local.clamp(0, n - 1), table)
    return torch.where(inside[..., None], out, 0).to(table.dtype)


# -- fused ops ----------------------------------------------------------------

@register_kernel("fused_softmax_mask")
def fused_softmax_mask(x, mask):
    return torch.softmax(x.float() + mask.float(), dim=-1).to(x.dtype)


@register_kernel("fused_softmax_mask_upper_triangle")
def fused_softmax_mask_upper_triangle(x):
    """Softmax over the last axis with the columns past each row's index
    set to -1e30 (causal)."""
    r, c = x.shape[-2], x.shape[-1]
    keep = torch.ones((r, c), dtype=torch.bool, device=x.device).tril()
    logits = torch.where(keep, x.float(), -1e30)
    return torch.softmax(logits, dim=-1).to(x.dtype)


def _act(v, name):
    if name == "relu":
        return torch.relu(v)
    if name == "gelu":
        return F.gelu(v, approximate="tanh")
    if name in ("swiglu", "silu"):
        return F.silu(v)
    return v


@register_kernel("fused_gemm_epilogue")
def fused_gemm_epilogue(x, y, bias, trans_x=False, trans_y=False,
                        activation="none"):
    a = x.T if trans_x else x
    b = y.T if trans_y else y
    out = torch.matmul(a, b) + bias
    return _act(out, activation) if activation in ("relu", "gelu") else out


@register_kernel("fused_bias_act")
def fused_bias_act(x, bias=None, act_method="gelu"):
    return _act(x + bias if bias is not None else x, act_method)


@register_kernel("fused_linear_param_grad_add")
def fused_linear_param_grad_add(x, dout, dweight=None, dbias=None,
                                multi_precision=True, has_bias=True):
    """``dweight (+)= x^T @ dout`` and ``dbias (+)= sum(dout)``, both
    accumulated in float32 (the reference always does)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    df = dout.reshape(-1, dout.shape[-1]).float()
    dw = xf.T @ df
    if dweight is not None:
        dw = dw + dweight.float()
    if not has_bias:
        return dw
    db = df.sum(dim=0)
    if dbias is not None:
        db = db + dbias.float()
    return dw, db


@register_kernel("memory_efficient_attention")
def memory_efficient_attention(query, key, value, attn_mask=None,
                               dropout_p=0.0, scale=None, is_causal=False,
                               generator: Optional[torch.Generator] = None):
    """The composite attention (``nn.py:_sdpa``), layout ``[batch, seq,
    heads, head_dim]``."""
    return _sdpa(query, key, value, attn_mask, float(dropout_p), is_causal,
                 scale, generator)
