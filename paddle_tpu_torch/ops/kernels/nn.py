"""Plain tensor kernels of the Llama serving and training paths.

Counterparts in ``paddle_tpu/ops/kernels/nn.py``: ``swiglu`` (:58),
``linear`` (:91), ``embedding`` (:99), ``rms_norm`` (:124), ``rope``
(:679), ``scaled_dot_product_attention`` (:624), the ``flash_attention``
routing (:723), the ``flash_attn_unpadded`` routing (:761) and
``fused_softmax_ce`` (:839), and the registry's ``matmul`` (the tied
logits) and ``mean`` (the loss) of ``math.py``. They keep the
reference's order of casts, so a bf16 model rounds at the same places in
both packages. The op registry (``ops/dispatcher.py``) holds those whose
arguments are the reference op's.

Each public function here is the op at the choke point
(``dispatcher.hooked``: AMP cast, span, NaN/Inf check, tensor stats) under
the reference op's name; the routing calls the composite attention
directly, so one op is one hooked call, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dispatcher import hooked, register_kernel
from . import flash_attention as _fa
from . import flash_varlen as _fv
from . import tp_attention as _tpa
from .math import _matmul, _mean


@register_kernel("swiglu")
def _swiglu(x: torch.Tensor, y: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """silu(x) * y; with ``y=None`` the halves of x's last axis."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


@register_kernel("linear")
def _linear(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W (+ b), W in Paddle's ``[in, out]`` layout."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


@register_kernel("embedding")
def _embedding(x: torch.Tensor, weight: torch.Tensor, padding_idx=None,
               sparse: bool = False) -> torch.Tensor:
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` (>= 0) come
    out as zeros and pass no grad. ``sparse`` is accepted (the grad is
    dense, as in the reference)."""
    out = weight[x.long()]
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((x == padding_idx)[..., None],
                          out.new_zeros(()), out)
    return out


def _norm_dims(x: torch.Tensor, begin_norm_axis: int):
    return -1 if begin_norm_axis == -1 else \
        tuple(range(begin_norm_axis % x.dim(), x.dim()))


@register_kernel("rms_norm")
def _rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, epsilon: float = 1e-6,
              begin_norm_axis: int = -1) -> torch.Tensor:
    """Mean of squares in float32 over the axes from ``begin_norm_axis``,
    cast back to ``x.dtype``, then the weight multiply (in the weight's
    dtype, as the reference does) and the bias add."""
    acc = x.float()
    ms = acc.square().mean(dim=_norm_dims(x, begin_norm_axis), keepdim=True)
    out = (acc * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """GPT-J style: each (even, odd) pair rotated."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


@register_kernel("rope")
def _rope(q: torch.Tensor, k: Optional[torch.Tensor] = None,
          cos: Optional[torch.Tensor] = None,
          sin: Optional[torch.Tensor] = None,
          position_ids: Optional[torch.Tensor] = None,
          rotate_half_style: bool = True):
    """Rotary embedding over q/k ``[b, s, heads, head_dim]``.

    cos/sin: float32 half-concat tables ``[max_pos, head_dim]`` (or
    ``[1, seq, 1, head_dim]``), gathered at ``position_ids [b, s]`` in
    float32 and only then cast to q's dtype, as the reference does;
    without positions, ``[seq, head_dim]`` tables apply as they are.
    ``rotate_half_style`` True is the neox convention, False GPT-J's
    interleaved pairs (the tables re-laid to repeat per pair). Returns
    ``(q, k)``, or q alone when k is None."""
    rot = _rotate_half if rotate_half_style else _rotate_pairs

    def relayout(t):
        if rotate_half_style:
            return t
        return t[..., :t.shape[-1] // 2].repeat_interleave(2, dim=-1)

    if position_ids is not None:
        idx = position_ids.long()
        c = relayout(cos.reshape(-1, cos.shape[-1])[idx])[:, :, None, :]
        s = relayout(sin.reshape(-1, sin.shape[-1])[idx])[:, :, None, :]
    else:
        c, s = relayout(cos), relayout(sin)
        if c.dim() == 2:
            c, s = c[None, :, None, :], s[None, :, None, :]
    c, s = c.to(q.dtype), s.to(q.dtype)
    out_q = q * c + rot(q) * s
    if k is None:
        return out_q
    return out_q, k * c + rot(k) * s


@register_kernel("scaled_dot_product_attention")
def _sdpa(query, key, value, attn_mask=None, dropout_p: float = 0.0,
          is_causal: bool = False, scale: Optional[float] = None,
          generator: Optional[torch.Generator] = None):
    """The composite attention over ``[batch, seq, heads, head_dim]``, in
    plain torch ops: float32 scores, right-aligned causal mask and
    ``attn_mask`` (bool keeps, float adds) at -inf, softmax cast to q's
    dtype, dropout of the probabilities when ``dropout_p > 0`` (the mask
    from ``generator``, by default the port's generator for q's device,
    as the reference draws a fresh key each call; kept ones scaled by
    ``1 / (1 - p)``), then ``probs @ v`` in q's dtype. GQA repeats kv
    heads."""
    b, sq, h, d = query.shape
    sk = key.shape[1]
    if scale is None:
        scale = d ** -0.5
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    if k.shape[1] != h:
        rep = h // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if is_causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        if generator is None:
            from ...nn.initializer import default_generator
            generator = default_generator(probs.device)
        keep_p = 1.0 - dropout_p
        drop = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < keep_p
        probs = torch.where(drop, probs / keep_p, 0.0).to(q.dtype)
    return torch.matmul(probs, v).transpose(1, 2)


@register_kernel("flash_attention")
def _flash_attention(query, key, value, attn_mask=None,
                     dropout_p: float = 0.0, is_causal: bool = False,
                     scale: Optional[float] = None,
                     generator: Optional[torch.Generator] = None):
    """Attention routing, as the reference's ``flash_attention`` op: with
    no mask and no dropout, a shape the flash path takes (``supported``)
    goes to ``flash_attention.flash_attention`` (the kernels for a CUDA
    tensor, which raise on a head_dim or dtype they lack; the plain
    version for a CPU one); everything else, causal ``sq > sk``
    included, goes to the composite. Under tensor parallelism (fleet's
    mp > 1) q/k/v hold this rank's heads: the same path, counted in
    ``tp_attention.sharded`` (the reference's ``:736-755``)."""
    if attn_mask is None and dropout_p == 0.0 and _fa.supported(
            query.shape, key.shape, is_causal):
        if _tpa.current_tp_context() is not None:
            _tpa.count_sharded()
        return _fa.flash_attention(query, key, value, causal=is_causal,
                                   scale=scale)
    return _sdpa(query, key, value, attn_mask, dropout_p, is_causal, scale,
                 generator)


@register_kernel("flash_attn_unpadded")
def _flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                         max_seqlen_q=0, max_seqlen_k=0, scale=0.0,
                         causal=False):
    """Packed varlen attention, as the reference's ``flash_attn_unpadded``
    op: ``scale`` 0.0 or None means ``head_dim ** -0.5``, ``max_seqlen_*``
    are accepted and unused, ``cu_seqlens_*`` are cast to int32; then
    ``flash_varlen.flash_attn_unpadded`` (the kernels for a CUDA tensor,
    the plain version for a CPU one). Under tensor parallelism the heads
    are this rank's: the same path, counted in ``tp_attention.sharded``
    (the reference's ``:770-786``)."""
    scale = None if scale in (0.0, None) else scale
    if _tpa.current_tp_context() is not None:
        _tpa.count_sharded()
    return _fv.flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                   scale=scale, causal=causal)


CE_IGNORE = -100    # the standard LM padding label
_CE_ROWS = 1024     # rows per float32 chunk: bounds the temporaries


def _rows(logits: torch.Tensor) -> torch.Tensor:
    """``[..., S, V]`` logits as a ``[N, S, V]`` view (no copy for a
    slice such as ``logits[:, :-1]``)."""
    s = logits.shape[-2] if logits.dim() > 1 else 1
    return logits.reshape(-1, s, logits.shape[-1])


def _chunks(n: int, s: int):
    for i in range(n):
        for r0 in range(0, s, _CE_ROWS):
            yield i, slice(r0, r0 + _CE_ROWS)


class _FusedSoftmaxCE(torch.autograd.Function):
    """Per-position CE over the last axis with the logits left in their
    own dtype: the float32 math runs on row chunks inside the reductions,
    and only ``(logits, labels, lse)`` are saved (no float32 logits copy,
    no saved probs); the backward recomputes ``p`` from the logits."""

    @staticmethod
    def forward(ctx, logits, labels):
        x3 = _rows(logits)
        lab = labels.long().reshape(x3.shape[:2])
        safe = torch.where(lab != CE_IGNORE, lab, 0)
        lse = torch.empty(lab.shape, dtype=torch.float32,
                          device=logits.device)
        picked = torch.empty_like(lse)
        for i, rs in _chunks(*lab.shape):
            x = x3[i, rs].float()
            m = x.amax(dim=-1, keepdim=True)
            lse[i, rs] = (m + torch.log(torch.exp(x - m).sum(
                dim=-1, keepdim=True)))[:, 0]
            picked[i, rs] = x.gather(-1, safe[i, rs, None])[:, 0]
        loss = torch.where(lab != CE_IGNORE, lse - picked, 0.0)
        ctx.save_for_backward(logits, lab, lse)
        return loss.reshape(labels.shape)

    @staticmethod
    def backward(ctx, ct):
        logits, lab, lse = ctx.saved_tensors
        x3 = _rows(logits)
        valid = lab != CE_IGNORE
        safe = torch.where(valid, lab, 0)
        w = torch.where(valid, ct.reshape(lab.shape).float(), 0.0)
        grad = torch.empty(x3.shape, dtype=logits.dtype, device=logits.device)
        for i, rs in _chunks(*lab.shape):
            p = torch.exp(x3[i, rs].float() - lse[i, rs, None])
            p.scatter_add_(-1, safe[i, rs, None],
                           torch.full_like(p[:, :1], -1.0))   # p - onehot
            grad[i, rs] = (p * w[i, rs, None]).to(logits.dtype)
        return grad.reshape(logits.shape), None


@register_kernel("fused_softmax_ce")
def _fused_softmax_ce(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """Per-position cross entropy ``lse - logits[label]`` in float32 over
    the last axis; label -100 gives 0 and no gradient."""
    return _FusedSoftmaxCE.apply(logits, labels)


@register_kernel("ring_attention")
def _ring_attention(query, key, value, is_causal: bool = False,
                    scale: Optional[float] = None):
    """Sequence-parallel attention, as the reference's ``ring_attention``
    op (``paddle_tpu/ops/kernels/nn.py:660-675``): with fleet's sep degree
    above 1, q/k/v are this rank's sequence shard and
    ``ring_attention.ring_attention`` runs over the sep group; otherwise
    the composite. Under tensor parallelism the heads are this rank's
    (counted in ``tp_attention.sharded``); inside
    ``tp_attention.head_replicated()`` they are every head, recorded as
    the reference's ``ring_head_replicated`` (:203-210)."""
    from ...distributed.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_sep_parallel_world_size() <= 1:
        return _sdpa(query, key, value, is_causal=is_causal, scale=scale)
    from . import ring_attention as _ra
    tp = hcg.get_model_parallel_world_size()
    if tp > 1:
        if _tpa.current_tp_context() is not None:
            _tpa.count_sharded()
        else:
            _tpa.record_fallback(
                "ring", "ring_head_replicated",
                f"heads {query.shape[2]}/{key.shape[2]} not divisible by "
                f"tp degree {tp} (head-replicated ring instead)")
    return _ra.ring_attention(query, key, value,
                              hcg.get_sep_parallel_group(),
                              causal=is_causal, scale=scale)


# the ops, by the reference's op names (``matmul`` and ``mean`` are the
# registry's, of ``math.py``: the Llama path's tied logits and loss)
swiglu = hooked("swiglu", _swiglu)
linear = hooked("linear", _linear)
matmul = hooked("matmul", _matmul)
mean = hooked("mean", _mean)
embedding = hooked("embedding", _embedding)
rms_norm = hooked("rms_norm", _rms_norm)
rope = hooked("rope", _rope)
scaled_dot_product_attention = hooked("scaled_dot_product_attention", _sdpa)
flash_attention = hooked("flash_attention", _flash_attention)
ring_attention = hooked("ring_attention", _ring_attention)
flash_attn_unpadded = hooked("flash_attn_unpadded", _flash_attn_unpadded)
fused_softmax_ce = hooked("fused_softmax_ce", _fused_softmax_ce)


# -- the layer ops (``nn/layers_common.py``, ``nn/loss.py``) -----------------
# Counterparts of the reference ops of ``paddle_tpu/ops/kernels/nn.py``
# (activations :17-74 and ``glu`` / ``gumbel_softmax``, norms :107-197,
# conv and pooling :200-455 with ``unfold`` :440, losses :462-636),
# ``math.py`` (sigmoid, tanh, logsigmoid), ``manipulation.py``
# (flatten :99, pad :240, one_hot :358) and ``random.py`` (dropout :96).
# No op here has a Pallas kernel: products and convolutions stay
# ``torch.matmul`` / ``F.conv2d``, as the reference's stay XLA's.

def _act(name, fn):
    register_kernel(name)(fn)
    return hooked(name, fn)


relu = _act("relu", lambda x: F.relu(x))
relu6 = _act("relu6", lambda x: F.relu6(x))
elu = _act("elu", lambda x, alpha=1.0: F.elu(x, alpha))
selu = _act("selu", lambda x: F.selu(x))
softplus = _act("softplus", lambda x, beta=1.0, threshold=20.0:
                F.softplus(x, beta, threshold))
softsign = _act("softsign", lambda x: F.softsign(x))
silu = _act("silu", lambda x: F.silu(x))
swish = _act("swish", lambda x: F.silu(x))
mish = _act("mish", lambda x: F.mish(x))
hardswish = _act("hardswish", lambda x: F.hardswish(x))
hardsigmoid = _act("hardsigmoid",
                   lambda x, slope=0.16666666666666666, offset=0.5:
                   torch.clamp(x * slope + offset, 0.0, 1.0))
leaky_relu = _act("leaky_relu", lambda x, negative_slope=0.01:
                  F.leaky_relu(x, negative_slope))
prelu = _act("prelu", lambda x, weight: torch.where(x >= 0, x, weight * x))
sigmoid = _act("sigmoid", lambda x: torch.sigmoid(x))
tanh = _act("tanh", lambda x: torch.tanh(x))
logsigmoid = _act("logsigmoid", lambda x: F.logsigmoid(x))
gelu = _act("gelu", lambda x, approximate=False:
            F.gelu(x, approximate="tanh" if approximate else "none"))
softmax = _act("softmax", lambda x, axis=-1: torch.softmax(x, dim=axis))
log_softmax = _act("log_softmax",
                   lambda x, axis=-1: torch.log_softmax(x, dim=axis))
celu = _act("celu", lambda x, alpha=1.0: F.celu(x, alpha))
hardtanh = _act("hardtanh", lambda x, min=-1.0, max=1.0:
                torch.clamp(x, min, max))
tanhshrink = _act("tanhshrink", lambda x: x - torch.tanh(x))
softshrink = _act("softshrink", lambda x, threshold=0.5: torch.where(
    x > threshold, x - threshold,
    torch.where(x < -threshold, x + threshold, 0.0)))
hardshrink = _act("hardshrink", lambda x, threshold=0.5:
                  torch.where(x.abs() > threshold, x, 0.0))
thresholded_relu = _act("thresholded_relu", lambda x, threshold=1.0:
                        torch.where(x > threshold, x, 0.0))


@register_kernel("glu")
def _glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_noise(shape, dtype, generator) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in (0, 1) from
    ``generator``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (-torch.log(-torch.log(u.clamp(min=tiny)))).to(dtype)


@register_kernel("gumbel_softmax")
def _gumbel_softmax(x, temperature=1.0, hard=False, axis=-1,
                    generator: Optional[torch.Generator] = None):
    """softmax((x + g) / temperature) with Gumbel noise g from
    ``generator`` (by default the port's generator for x's device; the
    reference's op takes a fresh key); ``hard``: the one-hot of the
    argmax forward, the soft grads backward (straight through)."""
    if generator is None:
        from ...nn.initializer import default_generator
        generator = default_generator(x.device)
    y = torch.softmax((x + gumbel_noise(x.shape, x.dtype, generator))
                      / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y


glu = hooked("glu", _glu)
gumbel_softmax = hooked("gumbel_softmax", _gumbel_softmax)


# -- norms --------------------------------------------------------------------

def _bcast(x: torch.Tensor, data_format: str):
    """The per-channel broadcast shape: channels at 1 (NC...) or last."""
    if data_format in ("NCHW", "NCL", "NCDHW"):
        return [1, -1] + [1] * (x.dim() - 2)
    return [1] * (x.dim() - 1) + [-1]


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@register_kernel("layer_norm")
def _layer_norm(x, weight=None, bias=None, epsilon=1e-05,
                begin_norm_axis=-1):
    """Normalized over the axes from ``begin_norm_axis`` with the biased
    variance, then the weight and bias (shaped as those axes)."""
    dims = _norm_dims(x, begin_norm_axis)
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@register_kernel("batch_norm_infer")
def _batch_norm_infer(x, running_mean, running_var, weight=None, bias=None,
                      epsilon=1e-05, data_format="NCHW"):
    shape = _bcast(x, data_format)
    out = (x - running_mean.reshape(shape)) \
        * torch.rsqrt(running_var.reshape(shape) + epsilon)
    return _affine(out, weight, bias, shape)


@register_kernel("batch_norm_train")
def _batch_norm_train(x, weight=None, bias=None, epsilon=1e-05,
                      data_format="NCHW"):
    """``(out, batch mean, batch variance)``: the statistics over every
    axis but the channel, the variance biased (the reference's
    ``jnp.var``); updating running statistics is the layer's."""
    shape = _bcast(x, data_format)
    ch = 1 if shape[1] == -1 else x.dim() - 1
    dims = tuple(d for d in range(x.dim()) if d != ch)
    mean = x.mean(dim=dims)
    var = x.var(dim=dims, correction=0)
    out = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                  + epsilon)
    return _affine(out, weight, bias, shape), mean, var


@register_kernel("group_norm")
def _group_norm(x, weight=None, bias=None, epsilon=1e-05, groups=1,
                data_format="NCHW"):
    if data_format != "NCHW":
        x = x.movedim(-1, 1)
    n, c = x.shape[:2]
    g = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    dims = tuple(range(2, g.dim()))
    mean = g.mean(dim=dims, keepdim=True)
    var = g.var(dim=dims, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    out = _affine(out, weight, bias, [1, c] + [1] * (x.dim() - 2))
    return out.movedim(1, -1) if data_format != "NCHW" else out


@register_kernel("instance_norm")
def _instance_norm(x, weight=None, bias=None, epsilon=1e-05):
    dims = tuple(range(2, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    return _affine(out, weight, bias, [1, -1] + [1] * (x.dim() - 2))


# -- convolution and pooling --------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size, k, s, d):
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


@register_kernel("conv2d")
def _conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
            data_format="NCHW"):
    """One ``F.conv2d`` (kernel ``[out, in/groups, kh, kw]``); ``padding``
    an int, a pair, ``[top, bottom, left, right]`` or "SAME" / "VALID";
    NHWC is moved to NCHW and back. The output keeps x's dtype."""
    stride, dilation = _pair(stride), _pair(dilation)
    nhwc = data_format != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0), (0, 0)]
        else:
            pads = [_same_pads(x.shape[2 + i], weight.shape[2 + i],
                               stride[i], dilation[i]) for i in range(2)]
    else:
        p = _pair(padding)
        pads = [(p[0], p[0]), (p[1], p[1])] if len(p) == 2 else \
            [(p[0], p[1]), (p[2], p[3])]
    if all(lo == hi for lo, hi in pads):
        out = F.conv2d(x, weight, None, stride, (pads[0][0], pads[1][0]),
                       dilation, groups)
    else:
        x = F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        out = F.conv2d(x, weight, None, stride, 0, dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    return out.to(x.dtype)


@register_kernel("conv1d")
def _conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
            data_format="NCL"):
    """The 1-D convolution as a conv2d over a unit height, as the
    reference computes it."""
    ncl = data_format == "NCL"
    x4 = x[:, :, None, :] if ncl else x[:, None, :, :]
    first = (lambda v: v if isinstance(v, int) else v[0])
    pd = padding if isinstance(padding, str) else (0, first(padding))
    out = _conv2d(x4, weight[:, :, None, :], bias, stride=(1, first(stride)),
                  padding=pd, dilation=(1, first(dilation)), groups=groups,
                  data_format="NCHW" if ncl else "NHWC")
    return out[:, :, 0, :] if ncl else out[:, 0, :, :]


@register_kernel("conv2d_transpose")
def _conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                      output_padding=0, dilation=1, groups=1,
                      data_format="NCHW"):
    """``F.conv_transpose2d``: the kernel ``[in, out/groups, kh, kw]`` in
    Paddle's layout, which is torch's."""
    return F.conv_transpose2d(x, weight, bias, _pair(stride), _pair(padding),
                              _pair(output_padding), groups, _pair(dilation))


def _nchw(x, data_format, fn):
    if data_format == "NCHW":
        return fn(x)
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _ceil_pads(x, k, st, pad):
    """Per spatial axis (low, high) padding: ``pad`` each side, plus, in
    ceil mode, enough on the high side for the last partial window (the
    reference's ``pool2d``, ``extra_nn.py:173-199``); and whether any
    window reaches padding."""
    pads, padded = [], any(pad)
    for i in range(2):
        size = x.shape[2 + i] + 2 * pad[i] - k[i]
        extra = (-(-size // st[i]) - size // st[i]) * st[i]
        pads.append((pad[i], pad[i] + extra))
        padded = padded or extra > 0
    return pads, padded


def _pool_ceil(t, k, st, pad, op, exclusive=True):
    """A window pool over ``t`` padded as :func:`_ceil_pads` says: max
    over -inf padding; avg over zeros, divided by the window's unpadded
    elements (``exclusive``) or by the whole k·k."""
    pads, padded = _ceil_pads(t, k, st, pad)
    (t0, t1), (l0, l1) = pads
    flat = (l0, l1, t0, t1)
    if op == "max":
        fill = float("-inf") if t.is_floating_point() \
            else torch.iinfo(t.dtype).min
        return F.max_pool2d(F.pad(t, flat, value=fill), k, st)
    acc = t.float()
    out = F.avg_pool2d(F.pad(acc, flat), k, st, divisor_override=1)
    if exclusive and padded:
        ones = F.pad(torch.ones_like(acc[:1, :1]), flat)
        out = out / F.avg_pool2d(ones, k, st, divisor_override=1) \
            .clamp(min=1.0)
    else:
        out = out / float(k[0] * k[1])
    return out.to(t.dtype)


@register_kernel("max_pool2d")
def _max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                data_format="NCHW"):
    """Max over each window, padding at -inf; ``ceil_mode`` keeps the
    last partial window as the reference's ``pool2d`` op does."""
    k = _pair(kernel_size)
    st = k if stride is None else _pair(stride)
    if ceil_mode:
        return _nchw(x, data_format, lambda t: _pool_ceil(
            t, k, st, _pair(padding), "max"))
    return _nchw(x, data_format, lambda t: F.max_pool2d(
        t, k, st, _pair(padding)))


@register_kernel("avg_pool2d")
def _avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                exclusive=True, data_format="NCHW"):
    """``exclusive`` divides by the window's unpadded elements, else by
    the whole k·k (in ceil mode too, as the reference's ``pool2d``, where
    torch's ``count_include_pad`` would clip the divisor at the edge)."""
    k = _pair(kernel_size)
    st = k if stride is None else _pair(stride)
    if ceil_mode:
        return _nchw(x, data_format, lambda t: _pool_ceil(
            t, k, st, _pair(padding), "avg", exclusive))
    return _nchw(x, data_format, lambda t: F.avg_pool2d(
        t, k, st, _pair(padding), count_include_pad=not exclusive))


def _out_size(output_size):
    return _pair(output_size) if isinstance(output_size, int) \
        else tuple(output_size)


@register_kernel("adaptive_avg_pool2d")
def _adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Paddle's bins (floor start, ceil end), torch's too; None keeps an
    axis."""
    return _nchw(x, data_format, lambda t: F.adaptive_avg_pool2d(
        t, _out_size(output_size)))


@register_kernel("adaptive_max_pool2d")
def _adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return _nchw(x, data_format, lambda t: F.adaptive_max_pool2d(
        t, _out_size(output_size)))


@register_kernel("interpolate_nearest")
def _interpolate_nearest(x, out_h, out_w, data_format="NCHW"):
    """Integer upscales repeat each pixel; other sizes sample the nearest
    pixel centre (``nearest-exact``, the reference's ``jax.image``)."""
    def run(t):
        h, w = t.shape[2:]
        if out_h % h == 0 and out_w % w == 0 and out_h >= h and out_w >= w:
            return t.repeat_interleave(out_h // h, dim=2) \
                .repeat_interleave(out_w // w, dim=3)
        return F.interpolate(t, size=(out_h, out_w), mode="nearest-exact")
    return _nchw(x, data_format, run)


@register_kernel("interpolate_bilinear")
def _interpolate_bilinear(x, out_h, out_w, align_corners=False,
                          data_format="NCHW"):
    """Half-pixel bilinear (antialiased when shrinking, as ``jax.image``
    is), or corner-aligned."""
    align = bool(align_corners) and out_h > 1 and out_w > 1
    return _nchw(x, data_format, lambda t: F.interpolate(
        t, size=(out_h, out_w), mode="bilinear", align_corners=align,
        antialias=not align).to(t.dtype))


@register_kernel("pixel_shuffle")
def _pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    return F.pixel_shuffle(x, upscale_factor)


@register_kernel("unfold")
def _unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C·kh·kw, L]`` patches, C major (``F.unfold``)."""
    return F.unfold(x, _pair(kernel_sizes), _pair(dilations),
                    _pair(paddings), _pair(strides))


@register_kernel("flatten")
def _flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@register_kernel("pad")
def _pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """``pad`` gives (low, high) per axis from the first when it covers
    every axis; otherwise pairs from the LAST spatial axis inward (the
    reference's ``nn/functional/common.py`` order)."""
    pad = [int(p) for p in pad]
    if len(pad) == 2 * x.dim():
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        spatial = [(pad[2 * i], pad[2 * i + 1])
                   for i in range(len(pad) // 2)][::-1]
        if data_format in ("NCHW", "NCL", "NCDHW"):
            widths = [(0, 0), (0, 0)] + spatial
        else:
            widths = [(0, 0)] + spatial + [(0, 0)]
    flat = [w for lo_hi in reversed(widths) for w in lo_hi]
    if mode == "constant":
        return F.pad(x, flat, mode="constant", value=value)
    while flat[-2:] == [0, 0]:       # F.pad's other modes pad trailing axes
        flat = flat[:-2]
    return F.pad(x, flat, mode=mode)


@register_kernel("one_hot")
def _one_hot(x, num_classes):
    return F.one_hot(x.long(), num_classes).float()


@register_kernel("dropout")
def _dropout(x, p=0.5, training=True, mode="upscale_in_train",
             generator: Optional[torch.Generator] = None, axis=None):
    """Keep each element with probability ``1 - p`` (``upscale_in_train``
    scales the kept ones by ``1 / (1 - p)``); outside training the input
    passes through. The mask draws from ``generator`` (uniform float32 <
    1 - p), by default the port's generator for x's device, never torch's
    global one; ``axis`` draws one mask value per index of those axes."""
    if not training or p == 0.0:
        return x
    if generator is None:
        from ...nn.initializer import default_generator
        generator = default_generator(x.device)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = [n if d in axes else 1 for d, n in enumerate(shape)]
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, 0.0).to(x.dtype)


# -- losses -------------------------------------------------------------------

def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _softmax_ce(logits, label, soft_label, ignore_index, axis):
    """Per-row CE with the class axis kept (size 1)."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        return -(label * logp).sum(dim=axis, keepdim=True)
    lab = label
    if lab.dim() == logits.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    lab = lab.long()
    nll = -logp.gather(axis, torch.where(lab == ignore_index, 0, lab)
                       .unsqueeze(axis))
    return torch.where((lab != ignore_index).unsqueeze(axis), nll, 0.0)


@register_kernel("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(logits, label, soft_label=False,
                                ignore_index=-100, axis=-1):
    """Per-row CE with the class axis kept (size 1); ignored rows 0."""
    return _softmax_ce(logits, label, soft_label, ignore_index, axis)


@register_kernel("cosine_similarity")
def _cosine_similarity(x1, x2, axis=1, eps=1e-08):
    """``<x1, x2> / max(|x1| |x2|, eps)`` (the product of the norms
    clipped, as the reference does, not each norm)."""
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


@register_kernel("hinge_embedding_loss")
def _hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1.0, input,
                       torch.clamp(margin - input, min=0))
    return _reduce(loss, reduction)


@register_kernel("cross_entropy_mean")
def _cross_entropy_mean(logits, label, soft_label=False, ignore_index=-100,
                        axis=-1, weight=None, reduction="mean"):
    """Softmax cross entropy over ``axis``; hard labels ``[N]`` or
    ``[N, 1]``; ``mean`` over the unignored rows (or the class-weighted
    mean), as the reference reduces."""
    loss = _softmax_ce(logits, label, soft_label, ignore_index, axis) \
        .squeeze(axis)
    if not soft_label and label.dim() == logits.dim() \
            and label.shape[axis] == 1:
        label = label.squeeze(axis)
    if weight is not None and not soft_label:
        lab = label.long()
        w = torch.where(lab == ignore_index, 0.0,
                        weight[torch.where(lab == ignore_index, 0, lab)])
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    if reduction == "mean":
        if not soft_label:
            valid = (label != ignore_index).to(loss.dtype)
            return loss.sum() / torch.clamp(valid.sum(), min=1.0)
        return loss.mean()
    return _reduce(loss, reduction)


@register_kernel("nll_loss")
def _nll_loss(log_prob, label, weight=None, ignore_index=-100,
              reduction="mean"):
    if label.dim() == log_prob.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    lab = label.long()
    safe = torch.where(lab == ignore_index, 0, lab)
    nll = -log_prob.gather(-1, safe[..., None])[..., 0]
    w = (lab != ignore_index).to(log_prob.dtype)
    if weight is not None:
        w = weight[safe] * w
    nll = nll * w
    if reduction == "mean":
        return nll.sum() / torch.clamp(w.sum(), min=1e-12)
    return _reduce(nll, reduction)


@register_kernel("mse_loss")
def _mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


@register_kernel("l1_loss")
def _l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


@register_kernel("smooth_l1_loss")
def _smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = input - label
    loss = torch.where(d.abs() < delta, 0.5 * d * d / delta,
                       d.abs() - 0.5 * delta)
    return _reduce(loss, reduction)


@register_kernel("binary_cross_entropy")
def _binary_cross_entropy(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@register_kernel("binary_cross_entropy_with_logits")
def _bce_with_logits(logit, label, weight=None, pos_weight=None,
                     reduction="mean"):
    max_val = torch.clamp(-logit, min=0)
    soft = torch.log1p(torch.exp(-logit.abs())) + max_val
    if pos_weight is not None:
        soft = ((pos_weight - 1.0) * label + 1.0) * soft
    loss = (1 - label) * logit + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@register_kernel("kl_div")
def _kl_div(input, label, reduction="mean", log_target=False):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        safe = torch.where(label > 0, label, 1.0)
        loss = torch.where(label > 0, label * (torch.log(safe) - input), 0.0)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


layer_norm = hooked("layer_norm", _layer_norm)
batch_norm_infer = hooked("batch_norm_infer", _batch_norm_infer)
batch_norm_train = hooked("batch_norm_train", _batch_norm_train)
group_norm = hooked("group_norm", _group_norm)
instance_norm = hooked("instance_norm", _instance_norm)
conv2d = hooked("conv2d", _conv2d)
conv1d = hooked("conv1d", _conv1d)
conv2d_transpose = hooked("conv2d_transpose", _conv2d_transpose)
max_pool2d = hooked("max_pool2d", _max_pool2d)
avg_pool2d = hooked("avg_pool2d", _avg_pool2d)
adaptive_avg_pool2d = hooked("adaptive_avg_pool2d", _adaptive_avg_pool2d)
adaptive_max_pool2d = hooked("adaptive_max_pool2d", _adaptive_max_pool2d)
interpolate_nearest = hooked("interpolate_nearest", _interpolate_nearest)
interpolate_bilinear = hooked("interpolate_bilinear", _interpolate_bilinear)
pixel_shuffle = hooked("pixel_shuffle", _pixel_shuffle)
flatten = hooked("flatten", _flatten)
pad = hooked("pad", _pad)
one_hot = hooked("one_hot", _one_hot)
dropout = hooked("dropout", _dropout)
cross_entropy_mean = hooked("cross_entropy_mean", _cross_entropy_mean)
nll_loss = hooked("nll_loss", _nll_loss)
mse_loss = hooked("mse_loss", _mse_loss)
l1_loss = hooked("l1_loss", _l1_loss)
smooth_l1_loss = hooked("smooth_l1_loss", _smooth_l1_loss)
binary_cross_entropy = hooked("binary_cross_entropy", _binary_cross_entropy)
binary_cross_entropy_with_logits = hooked(
    "binary_cross_entropy_with_logits", _bce_with_logits)
kl_div = hooked("kl_div", _kl_div)
unfold = hooked("unfold", _unfold)
softmax_with_cross_entropy = hooked("softmax_with_cross_entropy",
                                    _softmax_with_cross_entropy)
cosine_similarity = hooked("cosine_similarity", _cosine_similarity)
hinge_embedding_loss = hooked("hinge_embedding_loss", _hinge_embedding_loss)
