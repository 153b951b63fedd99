"""MoE routing and the routed expert FFN.

Counterpart of ``paddle_tpu/ops/kernels/moe.py``: ``moe_capacity`` (:39),
``route_topk`` (:46), ``_expert_mlp`` (:87), ``_dispatch_gather`` (:96),
``_combine_scatter`` (:105), ``_moe_local`` (:114), ``moe_ffn`` (:157) and
the ``grouped_gemm`` op (:205). Routing is index based: top-k softmax
gating with a GShard capacity bound gives per-expert slot indices
``idx [E, C]``, combine weights ``w [E, C]`` and live counts ``counts
[E]``; dispatch is a gather into the ``[E, C, h]`` capacity buffer, the
experts are three grouped products (``grouped_gemm.py``, the CUDA kernel on
the card) and combine is a weighted scatter-add back to token order. The
load-balance loss is the Switch-Transformer form.

Everything stays on the device: ``counts`` reaches the kernel as a device
tensor and C comes from the static token count, so a layer makes no host
sync. The scatter-adds (``_combine_scatter`` and the gather's backward)
sum float32 contributions with ``index_add_``, which on the card uses
atomics: their order, and so the last bits of the sums, change from run
to run.

Expert parallelism (``moe_ffn(expert_axis=)``, the reference's
``_moe_ep_body``, :128-155): where fleet's topology gives the axis a
degree ``n > 1`` that divides E, rank r runs experts ``[r E/n, (r + 1)
E/n)``. Its own tokens are routed with the capacity of its own token
count (the reference's per-shard capacity); the ``[E, C, h]`` buffer and
the counts go to the experts' owners by two all-to-alls (each an
autograd function whose backward is the reverse all-to-all), the owner
runs its experts through the grouped GEMM over the ``n`` shards' slots
(``groups_per_expert = n``, the counts it received), and a third
all-to-all brings the outputs home for the combine. The load-balance loss
is averaged over the axis in value (the reference's ``pmean``); its grad
stays the rank's own, which the data-parallel mean of the grads makes the
mean's. Where E does not divide, or the ranks' token counts differ (the
all-to-alls need equal buffers), every expert runs locally, counted in
``moe.ep_fallback`` and written into the flight recorder; cut weights are
then all-gathered first (their grads reduce-scattered back). The token
counts are checked by one all-reduce, once a model forward where the
model wraps its layers in :func:`ep_tokens_checked`.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...observability import flight_recorder as _flight
from ...observability import metrics as _metrics
from ..dispatcher import register_kernel
from .grouped_gemm import grouped_matmul

_M_EP = _metrics.registry().counter(
    "moe.ep_calls", "moe_ffn calls run expert-parallel")
_M_EP_FALLBACK = _metrics.registry().counter(
    "moe.ep_fallback",
    "moe_ffn calls under an expert axis run on every expert locally")


def moe_capacity(num_tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Per-expert slot budget (the reference gate's convention)."""
    c = int(capacity_factor * num_tokens * top_k / num_experts)
    return max(c, top_k, 4)


def route_topk(x: torch.Tensor, gate_w: torch.Tensor, top_k: int,
               capacity: int):
    """Top-k softmax routing with capacity-bounded slot assignment.

    x [t, h], gate_w [h, E] -> (idx [E, C] int32, the token of each slot,
    t for an empty one; w [E, C] float32 combine weight, 0 for empty or
    dropped; counts [E] int32 live slots; aux, the Switch load-balance
    loss). Slot priority is (k, token order): every k=0 choice claims its
    position before any k=1 choice. Choices past capacity are dropped and
    land in the dummy slot ``E*C``, which is cut off."""
    t = x.shape[0]
    E = gate_w.shape[1]
    K, C = top_k, capacity
    logits = torch.matmul(x.float(), gate_w.float())
    probs = torch.softmax(logits, dim=-1)                    # [t, E]
    topv, topi = torch.topk(probs, K, dim=-1)                # [t, K]

    me = probs.mean(dim=0)
    ce = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    aux = (me * ce).sum() * float(E)

    # position of each (k, token) choice within its expert, k-major order:
    # the choices of each expert counted by an inclusive scan along the
    # flat choice axis ([E, K*t], an inner-axis scan), read at the choice
    expert = topi.T                                          # [K, t]
    flat = expert.reshape(-1)                                # [K*t]
    oh = F.one_hot(flat, E).T.to(torch.int32).contiguous()   # [E, K*t]
    pos = (torch.cumsum(oh, dim=1, dtype=torch.int32)
           .gather(0, flat[None, :])[0] - 1).reshape(K, t)
    keep = pos < C
    wv = torch.where(keep, topv.T, 0.0)
    slot = torch.where(keep, expert * C + pos, E * C).reshape(-1)
    token_ids = torch.arange(t, dtype=torch.int32,
                             device=x.device).repeat(K)
    idx = torch.full((E * C + 1,), t, dtype=torch.int32, device=x.device) \
        .index_put((slot,), token_ids)
    w = torch.zeros((E * C + 1,), dtype=torch.float32, device=x.device) \
        .index_put((slot,), wv.reshape(-1).float())
    counts = torch.clamp(oh.sum(dim=1), max=C).to(torch.int32)
    return (idx[:E * C].reshape(E, C), w[:E * C].reshape(E, C), counts,
            aux)


def _expert_mlp(expert_in, gate_proj, up_proj, down_proj, counts, gpe: int,
                use_pallas: Optional[bool]):
    """SwiGLU expert FFN over the capacity buffer: three grouped products,
    silu in float32 then back to the buffer's dtype, as the reference."""
    g = grouped_matmul(expert_in, gate_proj, counts, gpe, use_pallas)
    u = grouped_matmul(expert_in, up_proj, counts, gpe, use_pallas)
    mid = F.silu(g.float()).to(g.dtype) * u
    return grouped_matmul(mid, down_proj, counts, gpe, use_pallas)


class _DispatchGather(torch.autograd.Function):
    """x [t, h] rows into the slots of idx [E, C] (an empty slot, idx ==
    t, reads zeros). The backward sums each token's float32 cotangents
    with ``index_add_`` (the empty slots into a spare row) and casts once
    to x's dtype."""

    @staticmethod
    def forward(ctx, x, idx):
        t = x.shape[0]
        valid = idx < t
        out = x[torch.where(valid, idx, 0).long()]
        ctx.save_for_backward(idx)
        ctx.t, ctx.dtype = t, x.dtype
        return torch.where(valid[..., None], out, 0)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gx = torch.zeros((ctx.t + 1, g.shape[-1]), dtype=torch.float32,
                         device=g.device)
        gx.index_add_(0, idx.reshape(-1).long(),
                      g.reshape(-1, g.shape[-1]).float())
        return gx[:ctx.t].to(ctx.dtype), None


def _dispatch_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [t, h], idx [E, C] -> [E, C, h]; empty slots (idx == t) are
    zeros."""
    return _DispatchGather.apply(x, idx)


def _combine_scatter(expert_out: torch.Tensor, idx: torch.Tensor,
                     w: torch.Tensor, t: int) -> torch.Tensor:
    """Weighted float32 scatter-add of expert outputs back to token order
    (row t collects the empty slots and is cut off)."""
    E, C, h = expert_out.shape
    contrib = expert_out.float() * w[..., None]
    out = torch.zeros((t + 1, h), dtype=torch.float32,
                      device=expert_out.device)
    out = out.index_add(0, idx.reshape(-1).long(), contrib.reshape(E * C, h))
    return out[:t]


def _moe_local(x, gate_w, gate_proj, up_proj, down_proj, top_k: int,
               capacity_factor: float, use_pallas: Optional[bool]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-shard routed experts: route -> gather -> GEMM -> scatter."""
    t = x.shape[0]
    E = gate_w.shape[1]
    C = moe_capacity(t, top_k, E, capacity_factor)
    idx, w, counts, aux = route_topk(x, gate_w, top_k, C)
    expert_in = _dispatch_gather(x, idx)
    expert_out = _expert_mlp(expert_in, gate_proj, up_proj, down_proj,
                             counts, 1, use_pallas)
    out = _combine_scatter(expert_out, idx, w, t)
    return out.to(x.dtype), aux


class _AllToAll(torch.autograd.Function):
    """``x [n, ...]``: chunk j goes to group rank j, chunk i of the result
    came from rank i. The exchange is its own adjoint: the backward is the
    same all-to-all of the grad."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    from ...distributed import collective as C
    return torch.stack(C.all_to_all([], list(x.contiguous().unbind(0)),
                                    group=group))


class _GatherExperts(torch.autograd.Function):
    """This rank's experts ``[E/n, ...]`` -> every expert ``[E, ...]``;
    the backward sums each rank's grad of the whole and hands every owner
    its slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, w, group):
        from ...distributed import collective as C
        ctx.group = group
        return torch.cat(C.all_gather([], w.contiguous(), group=group))

    @staticmethod
    def backward(ctx, g):
        from ...distributed import collective as C
        out = torch.empty((g.shape[0] // ctx.group.nranks,) + g.shape[1:],
                          dtype=g.dtype, device=g.device)
        C.reduce_scatter(out, g.contiguous(), group=ctx.group)
        return out, None


def _moe_ep(x, gate_w, gate_proj, up_proj, down_proj, group, top_k: int,
            capacity_factor: float, use_pallas: Optional[bool]):
    """The expert-parallel body on this rank's tokens and experts."""
    t, h = x.shape
    n = group.nranks
    E = gate_w.shape[1]
    El = E // n
    C_ = moe_capacity(t, top_k, E, capacity_factor)
    idx, w, counts, aux = route_topk(x, gate_w, top_k, C_)
    expert_in = _dispatch_gather(x, idx)                     # [E, C, h]
    # to the owners: [n (source rank), El, C, h] on each
    ei = _AllToAll.apply(expert_in.reshape(n, El, C_, h), group)
    cnt = _all_to_all(counts.reshape(n, El), group)          # [n, El]
    eo = _expert_mlp(ei.transpose(0, 1).reshape(El * n, C_, h), gate_proj,
                     up_proj, down_proj, cnt.t().reshape(El * n), n,
                     use_pallas)
    back = _AllToAll.apply(eo.reshape(El, n, C_, -1).transpose(0, 1), group)
    out = _combine_scatter(back.reshape(E, C_, -1), idx, w, t)
    from ...distributed import collective as C
    from ...distributed.fleet.mp_layers import all_reduce
    return out.to(x.dtype), all_reduce(aux, group, C.ReduceOp.AVG)


def _tokens_reason(group, num_tokens: int, device) -> Optional[str]:
    """Why the ranks of ``group`` cannot exchange ``num_tokens`` tokens
    each (their counts differ), or None: one small all-reduce and a host
    sync."""
    from ...distributed import collective as C
    span = torch.tensor([num_tokens, -num_tokens], dtype=torch.int64,
                        device=device)
    C.all_reduce(span, op=C.ReduceOp.MAX, group=group)
    hi, lo = span.tolist()
    if hi != -lo:
        return f"token counts {-lo}..{hi} differ over {group.nranks} ranks"
    return None


_CHECKED: dict = {}      # (axis, ranks) -> (token count, its reason)


@contextlib.contextmanager
def ep_tokens_checked(expert_axis: str, num_experts: int, num_tokens: int,
                      device):
    """Checks once whether the ranks of ``expert_axis``'s group hold
    ``num_tokens`` tokens alike; the ``moe_ffn`` calls inside on that many
    tokens take the answer instead of checking again (a model's forward
    wraps its MoE layers: one all-reduce a forward, not one a layer)."""
    group = _expert_group(expert_axis)
    if group is None or num_experts % group.nranks:
        yield
        return
    key = (group.axis, tuple(group.ranks))
    _CHECKED[key] = (num_tokens, _tokens_reason(group, num_tokens, device))
    try:
        yield
    finally:
        _CHECKED.pop(key, None)


def ep_fallback_reason(group, num_experts: int, num_tokens: int,
                       device) -> Optional[str]:
    """Why ``moe_ffn`` runs every expert locally over ``group``, or None:
    E does not divide over the ranks, or their token counts differ (taken
    from the enclosing :func:`ep_tokens_checked`, else checked here)."""
    n = group.nranks
    if num_experts % n:
        return f"{num_experts} experts do not divide over {n} ranks"
    checked = _CHECKED.get((group.axis, tuple(group.ranks)))
    if checked is not None and checked[0] == num_tokens:
        return checked[1]
    return _tokens_reason(group, num_tokens, device)


def _expert_group(expert_axis: str):
    from ...distributed.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None
    try:
        n = hcg.axis_degree(expert_axis)
    except KeyError:
        return None
    if n <= 1:
        return None
    return hcg.mesh.groups(expert_axis)[hcg.get_global_rank()]


@register_kernel("moe_ffn")
def moe_ffn(x, gate_weight, gate_proj, up_proj, down_proj, top_k: int = 2,
            capacity_factor: float = 1.25, expert_axis: str = "dp",
            use_pallas: Optional[bool] = None):
    """Routed top-k expert FFN: x [t, h] (this rank's tokens); gate_weight
    [h, E]; gate/up_proj [E, h, m] or this rank's ``[E/n, h, m]`` slice;
    down_proj likewise. Returns (out [t, h], aux scalar). Under fleet's
    topology with ``expert_axis``'s degree n > 1 the experts run
    expert-parallel (whole weights are cut to this rank's slice first);
    otherwise, and where the module docstring's fallback holds, locally.
    ``use_pallas=False`` takes the plain grouped product; otherwise the
    kernel runs for CUDA tensors."""
    top_k, capacity_factor = int(top_k), float(capacity_factor)
    group = _expert_group(expert_axis)
    E = gate_weight.shape[1]
    if group is None:
        return _moe_local(x, gate_weight, gate_proj, up_proj, down_proj,
                          top_k, capacity_factor, use_pallas)
    n, r = group.nranks, group.rank
    cut = gate_proj.shape[0] != E
    if cut and gate_proj.shape[0] * n != E:
        raise ValueError(f"expert weights of {gate_proj.shape[0]} experts "
                         f"are neither all {E} nor 1/{n} of them")
    why = ep_fallback_reason(group, E, x.shape[0], x.device)
    if why is not None:
        _M_EP_FALLBACK.inc()
        if _flight.enabled():
            _flight.recorder().record("moe.ep_fallback", (why,),
                                      expert_axis)
        if cut:
            gate_proj, up_proj, down_proj = (
                _GatherExperts.apply(p, group)
                for p in (gate_proj, up_proj, down_proj))
        return _moe_local(x, gate_weight, gate_proj, up_proj, down_proj,
                          top_k, capacity_factor, use_pallas)
    if not cut:
        El = E // n
        gate_proj, up_proj, down_proj = (
            p[r * El:(r + 1) * El] for p in (gate_proj, up_proj, down_proj))
    _M_EP.inc()
    return _moe_ep(x, gate_weight, gate_proj, up_proj, down_proj, group,
                   top_k, capacity_factor, use_pallas)


@register_kernel("grouped_gemm")
def grouped_gemm(x, w, counts=None, groups_per_expert: int = 1,
                 use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Ragged grouped matmul ``y[g] = x[g] @ w[g // groups_per_expert]``,
    rows past ``counts[g]`` zero (the reference's ``grouped_gemm`` op)."""
    return grouped_matmul(x, w, counts, int(groups_per_expert), use_pallas)
