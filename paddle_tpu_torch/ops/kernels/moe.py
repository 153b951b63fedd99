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

Single shard only: expert parallelism over a mesh axis (the reference's
``_moe_ep_body``, :128) is not ported yet, so ``moe_ffn`` takes no
``expert_axis`` and runs every expert locally.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dispatcher import register_kernel
from .grouped_gemm import grouped_matmul


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


def moe_ffn(x, gate_weight, gate_proj, up_proj, down_proj, top_k: int = 2,
            capacity_factor: float = 1.25,
            use_pallas: Optional[bool] = None):
    """Routed top-k expert FFN: x [t, h]; gate_weight [h, E]; gate/up_proj
    [E, h, m]; down_proj [E, m, h]. Returns (out [t, h], aux scalar).
    ``use_pallas=False`` takes the plain grouped product; otherwise the
    kernel runs for CUDA tensors. Every expert runs locally: the
    reference's ``expert_axis`` (expert parallelism) is not ported."""
    return _moe_local(x, gate_weight, gate_proj, up_proj, down_proj,
                      int(top_k), float(capacity_factor), use_pallas)


@register_kernel("grouped_gemm")
def grouped_gemm(x, w, counts=None, groups_per_expert: int = 1,
                 use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Ragged grouped matmul ``y[g] = x[g] @ w[g // groups_per_expert]``,
    rows past ``counts[g]`` zero (the reference's ``grouped_gemm`` op)."""
    return grouped_matmul(x, w, counts, int(groups_per_expert), use_pallas)
