"""Mixture-of-Experts layers.

Counterpart of ``paddle_tpu/nn/moe.py``: ``TopKGate`` (:41), ``ExpertFFN``
(:105) and ``MoELayer`` (:129), with the same parameter names and layouts
(gate ``[h, E]``; stacked expert weights ``[E, h, m]`` / ``[E, m, h]``).
``MoELayer`` runs the fused ``moe_ffn`` (``ops/kernels/moe.py``: index
routing, the grouped-GEMM kernel on the card, scatter-add combine) and
keeps the load-balance loss of its last forward on ``aux_loss``.
``TopKGate.forward`` is the reference's dense one-hot formulation, kept for
API parity; no layer calls it.

Expert parallelism (``MoELayer._shard_experts``, the reference's :147-160):
under fleet's topology, where ``expert_axis`` has a degree n > 1 that
divides E, the layer is built holding only its rank's ``E/n`` experts
(``experts.expert_group``; ``models.shard_state_dict`` cuts loaded
weights the same way) and ``moe_ffn`` exchanges tokens with the other
ranks. Each expert parameter is marked ``is_expert`` and ``no_sync`` with
its ``expert_group``: ``DataParallel`` does not all-reduce its grad (it is
already the sum over the ranks whose tokens reached it) but divides it by
the group's size, as the mean's gradient; the hybrid global-norm clip sums
its squares over the expert group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import moe as M
from ..ops.kernels import nn as K
from .initializer import ParamInit


class TopKGate(nn.Module):
    """Top-k softmax router with capacity: its weight ``[h, E]`` and
    ``capacity(t)``."""

    def __init__(self, hidden_size: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 init: Optional[ParamInit] = None):
        super().__init__()
        init = init or ParamInit.make()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.weight = init.normal(hidden_size, num_experts)

    def capacity(self, num_tokens: int) -> int:
        return M.moe_capacity(num_tokens, self.top_k, self.num_experts,
                              self.capacity_factor)

    def forward(self, x: torch.Tensor):
        """x [t, h] -> (combine [t, E, C], dispatch [t, E, C], aux): the
        dense formulation with running per-expert counts over k."""
        t = x.shape[0]
        E, Kk = self.num_experts, self.top_k
        C = self.capacity(t)
        probs = torch.softmax(torch.matmul(x.float(), self.weight.float()),
                              dim=-1)
        topv, topi = torch.topk(probs, Kk, dim=-1)
        me = probs.mean(dim=0)
        ce = F.one_hot(topi[:, 0], E).float().mean(dim=0)
        aux = (me * ce).sum() * float(E)
        combine = dispatch = counts = None
        for j in range(Kk):
            m_j = F.one_hot(topi[:, j], E).float()                 # [t, E]
            pos_in_e = torch.cumsum(m_j, dim=0) - m_j
            if counts is not None:
                pos_in_e = pos_in_e + counts
            pos = (pos_in_e * m_j).sum(dim=-1)                     # [t]
            keep = (pos < float(C)).float()
            gate_j = topv[:, j] * keep
            oh_c = F.one_hot(pos.long().clamp(max=C - 1), C).float() \
                * (pos < float(C)).float()[:, None]                # [t, C]
            d_j = m_j[:, :, None] * oh_c[:, None, :] * keep[:, None, None]
            c_j = d_j * gate_j[:, None, None]
            combine = c_j if combine is None else combine + c_j
            dispatch = d_j if dispatch is None else dispatch + d_j
            new = m_j.sum(dim=0, keepdim=True)
            counts = new if counts is None else counts + new
        return combine, dispatch, aux


class ExpertFFN(nn.Module):
    """Stacked SwiGLU expert weights driven by the grouped GEMM (one
    ragged product per projection, not a loop over experts)."""

    def __init__(self, num_experts: int, hidden_size: int,
                 intermediate_size: int, init: Optional[ParamInit] = None,
                 expert_group=None):
        super().__init__()
        init = init or ParamInit.make()
        self.num_experts = num_experts
        self.expert_group = expert_group
        E = num_experts if expert_group is None \
            else num_experts // expert_group.nranks
        h, m = hidden_size, intermediate_size
        self.gate_weight = init.normal(E, h, m)
        self.up_weight = init.normal(E, h, m)
        self.down_weight = init.normal(E, m, h)
        if expert_group is not None:
            for p in self.parameters():
                p.is_expert = p.no_sync = True
                p.expert_group = expert_group

    def forward(self, x: torch.Tensor,
                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [E, C, h] -> [E, C, h], ragged over experts."""
        g = M.grouped_gemm(x, self.gate_weight, counts)
        u = M.grouped_gemm(x, self.up_weight, counts)
        return M.grouped_gemm(K.swiglu(g, u), self.down_weight, counts)


class MoELayer(nn.Module):
    """Routed-experts block: forward(x [b, s, h]) -> [b, s, h]; the
    load-balance loss of the last forward is on ``aux_loss`` (read by the
    model's criterion)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 init: Optional[ParamInit] = None,
                 expert_axis: str = "dp"):
        super().__init__()
        init = init or ParamInit.make()
        self.gate = TopKGate(hidden_size, num_experts, top_k,
                             capacity_factor, init)
        self.expert_axis = expert_axis
        self.experts = ExpertFFN(num_experts, hidden_size, intermediate_size,
                                 init, self._shard_experts(expert_axis,
                                                           num_experts))
        self.aux_loss = None

    @staticmethod
    def _shard_experts(axis: str, E: int):
        """The group the experts are cut over, or None (no topology, a
        degree of 1, or E not dividing: every expert stays here)."""
        group = M._expert_group(axis)
        if group is None or E % group.nranks:
            return None
        return group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        out, aux = M.moe_ffn(
            x.reshape(b * s, h), self.gate.weight, self.experts.gate_weight,
            self.experts.up_weight, self.experts.down_weight,
            top_k=self.gate.top_k, capacity_factor=self.gate.capacity_factor,
            expert_axis=self.expert_axis)
        self.aux_loss = aux
        return out.to(x.dtype).reshape(b, s, h)
