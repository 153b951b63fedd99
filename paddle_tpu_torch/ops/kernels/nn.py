"""Plain tensor kernels of the Llama serving and training paths.

Counterparts in ``paddle_tpu/ops/kernels/nn.py``: ``swiglu`` (:58),
``linear`` (:91), ``embedding`` (:99), ``rms_norm`` (:124), ``rope``
(:679), ``scaled_dot_product_attention`` (:624), the ``flash_attention``
routing (:723), the ``flash_attn_unpadded`` routing (:761) and
``fused_softmax_ce`` (:839), and the two Tensor ops of the Llama path,
``matmul`` (the tied logits) and ``mean`` (the loss). They keep the
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


def _swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """silu(x) * y."""
    return F.silu(x) * y


def _linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ W, W in Paddle's ``[in, out]`` layout (Llama's linears have no
    bias)."""
    return torch.matmul(x, weight)


def _matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` (the reference's ``matmul`` op; the tied logits pass the
    transposed embedding)."""
    return torch.matmul(x, y)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element (the reference's ``Tensor.mean``)."""
    return x.mean()


def _embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight[ids.long()]


def _rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
              epsilon: float = 1e-6) -> torch.Tensor:
    """Mean of squares in float32, cast back to ``x.dtype``, then the
    weight multiply (in the weight's dtype, as the reference does)."""
    acc = x.float()
    ms = acc.square().mean(dim=-1, keepdim=True)
    out = (acc * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rope(q: torch.Tensor, k: Optional[torch.Tensor], cos: torch.Tensor,
          sin: torch.Tensor, position_ids: torch.Tensor
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Rotary embedding, rotate-half (neox) style.

    q/k ``[b, s, heads, head_dim]``; cos/sin float32 tables
    ``[max_pos, head_dim]``; position_ids ``[b, s]``. The tables are
    gathered at the positions in float32 and only then cast to q's dtype,
    as the reference does."""
    c = cos[position_ids.long()][:, :, None, :].to(q.dtype)
    s = sin[position_ids.long()][:, :, None, :].to(q.dtype)
    out_q = q * c + _rotate_half(q) * s
    if k is None:
        return out_q, None
    return out_q, k * c + _rotate_half(k) * s


@register_kernel("scaled_dot_product_attention")
def _sdpa(query, key, value, attn_mask=None, dropout_p: float = 0.0,
          is_causal: bool = False, scale: Optional[float] = None,
          generator: Optional[torch.Generator] = None):
    """The composite attention over ``[batch, seq, heads, head_dim]``, in
    plain torch ops: float32 scores, right-aligned causal mask and
    ``attn_mask`` (bool keeps, float adds) at -inf, softmax cast to q's
    dtype, dropout only when a generator is given (the reference needs an
    rng key), then ``probs @ v`` in q's dtype. GQA repeats kv heads."""
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
    if dropout_p > 0.0 and generator is not None:
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
    included, goes to the composite."""
    if attn_mask is None and dropout_p == 0.0 and _fa.supported(
            query.shape, key.shape, is_causal):
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
    the plain version for a CPU one). The reference's tensor-parallel
    branch (heads sharded over an ambient mesh) is not ported."""
    scale = None if scale in (0.0, None) else scale
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


# the ops, by the reference's op names
swiglu = hooked("swiglu", _swiglu)
linear = hooked("linear", _linear)
matmul = hooked("matmul", _matmul)
mean = hooked("mean", _mean)
embedding = hooked("embedding", _embedding)
rms_norm = hooked("rms_norm", _rms_norm)
rope = hooked("rope", _rope)
scaled_dot_product_attention = hooked("scaled_dot_product_attention", _sdpa)
flash_attention = hooked("flash_attention", _flash_attention)
flash_attn_unpadded = hooked("flash_attn_unpadded", _flash_attn_unpadded)
fused_softmax_ce = hooked("fused_softmax_ce", _fused_softmax_ce)
