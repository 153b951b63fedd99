"""Ring attention: attention with the sequence cut over the ``sep`` ranks.

Counterpart of ``paddle_tpu/ops/kernels/pallas/ring_attention.py``. The
reference is one program over a mesh: it rotates K/V around the ring with
``lax.ppermute`` inside ``shard_map`` and differentiates through the
scan. The port is one process per rank, and torch's autograd does not
differentiate through ``send`` / ``recv``, so :class:`_Ring` is one
``torch.autograd.Function`` with a backward written here.

Rank ``me`` of ``P`` holds the q, k and v of its sequence shard. At step
``j`` it holds the K/V of rank ``src = (me - j) % P``, and the block (q,
that K/V) is, under a causal mask, fully visible (``src < me``: flash,
not causal), the diagonal (``src == me``: causal flash) or fully masked
(``src > me``: nothing is launched), as the reference's ``lax.switch``
(:137-156). Without the mask every block is full. The forward:

- the K/V move on to the next rank through ``batch_isend_irecv``, posted
  before the step's kernel, so that the transfer overlaps it;
- each visible block's ``(o, lse)`` (the flash forward kernel) merges into
  float32 accumulators by ``logaddexp`` (:157-160).

The backward, with the merged lse and ``delta = rowsum(dout * out)``,
gives each block's exact share of the gradient through the flash
backward kernels (``flash_dq_kernel`` and ``flash_dkv_kernel`` on the
card), for the same full / diagonal / skipped blocks:

- dq accumulates in float32 on the rank;
- float32 dK / dV accumulators travel the ring with the K/V they belong
  to: after ``P`` moves each is back with its owner, holding every
  rank's contribution.

Under tensor parallelism each rank's heads are its own already (the
column-parallel q/k/v projections), so the ring runs on the local heads
(the reference's ``head_axis``, :186-213); where the head counts do not
cut over the mp ranks the caller runs the ring on every head,
recorded as ``ring_head_replicated`` (the ``ring_attention`` entry of
``ops/kernels/nn.py``).
A shape the flash path does not take (``flash_attention.supported``:
query heads not a multiple of the kv heads) raises, counted in
``ring_attention.unsupported``: the reference's composite blocks
(``_ring_local``) repeat K/V by ``hq // hk`` and cannot take those heads
either.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...distributed import collective as C
from ...observability import metrics as _metrics
from . import flash_attention as FA

_NEG = -1e30
_M_UNSUPPORTED = _metrics.registry().counter(
    "ring_attention.unsupported",
    "ring attention calls whose heads the flash path does not take")


def block_case(me: int, src: int, causal: bool) -> Optional[bool]:
    """The flash call for the block (q of rank ``me``, K/V of rank
    ``src``): its ``causal`` flag, or None where it is fully masked."""
    if not causal or src < me:
        return False
    return True if src == me else None


def _rotate(tensors, group: C.Group):
    """Post the sends of ``tensors`` to the next rank of the ring and the
    receives of as many from the previous one; returns (handles, the
    receive buffers)."""
    me, n = group.rank, group.nranks
    nxt, prv = group.ranks[(me + 1) % n], group.ranks[(me - 1) % n]
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [C.P2POp(C.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [C.P2POp(C.irecv, b, prv, group) for b in bufs]
    return C.batch_isend_irecv(ops), bufs


def _merge(o_acc, lse_acc, o_j, lse_j):
    """Fold a block's (o, lse) into the float32 accumulators."""
    lse = torch.logaddexp(lse_acc, lse_j)                      # [b, h, s]
    to = lambda w: w.transpose(1, 2).unsqueeze(-1)  # noqa: E731
    o = o_acc * to(torch.exp(lse_acc - lse)) \
        + o_j.float() * to(torch.exp(lse_j - lse))
    return o, lse


class _Ring(torch.autograd.Function):
    """(q, k, v) shards ``[b, s/P, h, d]`` -> the shard of the output; see
    the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        me, n = group.rank, group.nranks
        b, sl, hq, d = q.shape
        o = torch.zeros((b, sl, hq, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, hq, sl), _NEG, dtype=torch.float32,
                         device=q.device)
        kv = (k, v)
        for j in range(n):
            works = bufs = None
            if j < n - 1:
                works, bufs = _rotate(kv, group)
            case = block_case(me, (me - j) % n, causal)
            if case is not None:
                o_j, lse_j = FA.flash_fwd(q, kv[0], kv[1], case, scale)
                o, lse = _merge(o, lse, o_j, lse_j)
            if works is not None:
                for w in works:
                    w.wait()
                kv = tuple(bufs)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        me, n = group.rank, group.nranks
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()                                      # [b, h, s]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv = (k, v)
        acc = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device))
        for j in range(n):
            case = block_case(me, (me - j) % n, causal)
            if case is not None:
                dq_j, dk, dv = FA.flash_bwd(q, kv[0], kv[1], dout, lse,
                                            delta, case, scale)
                dq += dq_j.float()
                acc = (acc[0] + dk.float(), acc[1] + dv.float())
            if n == 1:
                break
            # the accumulators make P moves and come home; K/V need P - 1
            send = kv + acc if j < n - 1 else acc
            works, bufs = _rotate(send, group)
            for w in works:
                w.wait()
            if j < n - 1:
                kv, acc = tuple(bufs[:2]), tuple(bufs[2:])
            else:
                acc = tuple(bufs)
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None)


def ring_attention(query: torch.Tensor, key: torch.Tensor,
                   value: torch.Tensor, group: C.Group,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """``[b, s/P, h, d]`` attention over a sequence cut in ``P`` equal
    contiguous shards over ``group`` (rank r holds positions ``[r * s/P,
    (r + 1) * s/P)``); every rank of the group calls it with its shard.
    ``scale`` defaults to ``head_dim ** -0.5``. A CPU tensor takes the
    flash kernels' plain versions, a CUDA tensor the kernels."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    if not FA.supported(query.shape, key.shape, causal):
        _M_UNSUPPORTED.inc()
        raise ValueError(
            f"ring_attention: q {tuple(query.shape)} and k "
            f"{tuple(key.shape)} do not form GQA heads")
    return _Ring.apply(query, key, value, group, bool(causal), float(scale))
