"""MoE causal LM family: DeepSeekMoE / Qwen2-MoE style.

Counterpart of ``paddle_tpu/models/moe.py``: a Llama-style decoder whose
MLP is routed top-k experts plus optional always-on shared experts; the
first ``first_k_dense_replace`` layers keep a dense MLP (the DeepSeekMoE
convention). The same modules, names and parameter layouts, so the JAX
model's ``state_dict()`` loads name for name (``models/convert.py``).
Attention is the port's ``LlamaAttention`` (the flash kernels on the
card); the experts run through the grouped-GEMM kernel.

``MoEPretrainingCriterion`` is the shifted next-token cross entropy plus
``aux_loss_alpha`` times the sum of the MoE layers' load-balance losses.
The reference casts the ``[b, s-1, V]`` logits to float32 first; the port
takes ``fused_softmax_ce``, which computes the same function over the
logits in their own dtype (float32 row chunks inside the reductions).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike
from ..core.tensor import PaddleCall
from ..nn.initializer import ParamInit
from ..nn.moe import MoELayer
from ..ops.kernels import moe as M
from ..ops.kernels import nn as K
from .llama import (LlamaAttention, LlamaConfig, LlamaMLP, LlamaRMSNorm,
                    LlamaRotaryEmbedding, _embedding, _linear)


@dataclass
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0      # 0 -> intermediate_size
    num_shared_experts: int = 0         # DeepSeekMoE shared experts
    first_k_dense_replace: int = 1      # dense MLP in the first k layers
    capacity_factor: float = 1.25
    aux_loss_alpha: float = 0.01
    expert_axis: str = "dp"             # the axis the experts are cut over

    @staticmethod
    def tiny_moe(**kw) -> "MoEConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    num_experts=4, num_experts_per_tok=2,
                    moe_intermediate_size=32, num_shared_experts=1,
                    first_k_dense_replace=0)
        base.update(kw)
        return MoEConfig(**base)


class MoEMLP(nn.Module):
    """Routed experts plus optional always-on shared experts (one SwiGLU
    of width ``moe_intermediate_size * num_shared_experts``)."""

    def __init__(self, config: MoEConfig, init: ParamInit):
        super().__init__()
        m = config.moe_intermediate_size or config.intermediate_size
        self.moe = MoELayer(config.hidden_size, m, config.num_experts,
                            top_k=config.num_experts_per_tok,
                            capacity_factor=config.capacity_factor,
                            init=init, expert_axis=config.expert_axis)
        self.shared = None
        if config.num_shared_experts > 0:
            self.shared = LlamaMLP(LlamaConfig(
                hidden_size=config.hidden_size,
                intermediate_size=m * config.num_shared_experts), init)

    @property
    def aux_loss(self):
        return self.moe.aux_loss

    def forward(self, x):
        out = self.moe(x)
        if self.shared is not None:
            out = out + self.shared(x)
        return out


class MoEDecoderLayer(nn.Module):
    def __init__(self, config: MoEConfig, layer_idx: int,
                 rotary: LlamaRotaryEmbedding, init: ParamInit):
        super().__init__()
        self.self_attn = LlamaAttention(config, rotary, init)
        self.mlp = LlamaMLP(config, init) \
            if layer_idx < config.first_k_dense_replace \
            else MoEMLP(config, init)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size,
                                            config.rms_norm_eps, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, config.rms_norm_eps, init)

    def forward(self, x, attn_mask=None, position_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), attn_mask,
                               position_ids)
        return x + self.mlp(self.post_attention_layernorm(x))


class MoEModel(PaddleCall, nn.Module):
    def __init__(self, config: MoEConfig, init: ParamInit):
        super().__init__()
        self.config = config
        self.embed_tokens = _embedding(config.vocab_size,
                                       config.hidden_size, init)
        rotary = LlamaRotaryEmbedding(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta, init.device)
        self.layers = nn.ModuleList(
            [MoEDecoderLayer(config, i, rotary, init)
             for i in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 init)

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        # the last forward's aux losses go first: their graph reaches every
        # parameter before the MoE layers (the router reads the hidden
        # state), and kept alive into this forward it would hand its grad
        # accumulators, and the CUDA stream each was made on, to this one
        # (a captured step's backward then syncs with the legacy stream)
        for layer in self.layers:
            if isinstance(layer.mlp, MoEMLP):
                layer.mlp.moe.aux_loss = None
        x = self.embed_tokens(input_ids)
        # the expert-parallel layers' token counts, checked once
        with M.ep_tokens_checked(self.config.expert_axis,
                                 self.config.num_experts, input_ids.numel(),
                                 input_ids.device):
            for layer in self.layers:
                x = layer(x, attn_mask, position_ids)
        return self.norm(x)

    def collect_aux_loss(self) -> Optional[torch.Tensor]:
        total = None
        for layer in self.layers:
            aux = getattr(layer.mlp, "aux_loss", None)
            if aux is not None:
                total = aux if total is None else total + aux
        return total


class MoEForCausalLM(PaddleCall, nn.Module):
    """MoE causal LM. ``device=None`` means the CUDA card (raises when
    there is none); parameters are drawn normal(0, 0.02) from
    ``generator`` (default: a generator on the device seeded 0)."""

    def __init__(self, config: MoEConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = ParamInit.make(device, config.dtype, generator)
        self.config = config
        self.model = MoEModel(config, init)
        self.lm_head = _linear(config.hidden_size, config.vocab_size, init)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        return self.lm_head(self.model(input_ids, attn_mask, position_ids))


class MoEPretrainingCriterion(PaddleCall, nn.Module):
    """Next-token cross entropy (mean over all positions, label -100
    counts as 0) plus ``aux_loss_alpha`` x the MoE layers' aux losses."""

    def __init__(self, config: MoEConfig, model: MoEForCausalLM):
        super().__init__()
        self.alpha = config.aux_loss_alpha
        self._model = [model]   # not a submodule: no parameter double count

    def forward(self, logits, labels):
        loss = K.fused_softmax_ce(logits[:, :-1, :], labels[:, 1:]).mean()
        aux = self._model[0].model.collect_aux_loss()
        if aux is not None:
            loss = loss + self.alpha * aux
        return loss
