"""Llama model family: the serving and the training forward.

Counterpart of ``paddle_tpu/models/llama.py``: the same modules, names and
parameter layouts, so a JAX ``state_dict()`` maps onto this one name for
name (``models/convert.py``). Linear weights stay ``[in, out]`` (Paddle's
layout: ``x @ W``). Parameters are trainable, as in the reference.

Two forwards, both unsharded:

- with a cache (serving): each layer writes its K/V into the cache and
  attends through it (the paged kernels). It runs under ``no_grad``, so
  it never builds an autograd graph;
- without one (training, :189-201, :280-303): rope at ``position_ids`` (or
  ``arange(s)``), then causal attention through the ``flash_attention``
  routing (the flash kernels on the card), or the composite when
  ``use_flash_attention=False``. ``recompute=True`` re-runs each layer in
  the backward, ``recompute="selective"`` all but its matrix products
  (``distributed.recompute``); ``use_scan_layers`` stores the layers as
  one ``nn.LayerStack``.

``LlamaPretrainingCriterion`` (:327-339) is the shifted next-token cross
entropy through ``fused_softmax_ce``, averaged over all positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..core.device import DeviceLike
from ..core.tensor import PaddleCall
from ..distributed.recompute import dots_saveable, recompute
from ..nn.initializer import ParamInit
from ..nn.layers_common import Embedding, Linear
from ..nn.stack import LayerStack
from ..ops.kernels import nn as K
from .generation import GenerationMixin


def _linear(in_features: int, out_features: int, init: ParamInit) -> Linear:
    """A bias-free ``Linear`` drawn from the model's ``ParamInit``."""
    return Linear(in_features, out_features, weight_attr=init.attr(),
                  bias_attr=False)


def _embedding(num: int, dim: int, init: ParamInit) -> Embedding:
    return Embedding(num, dim, weight_attr=init.attr())


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    recompute: Union[bool, str] = False
    use_scan_layers: bool = False
    dtype: str = "float32"

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_hidden_layers=32,
                           num_attention_heads=32, num_key_value_heads=8,
                           max_position_embeddings=8192, rope_theta=500000.0,
                           dtype="bfloat16")

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, hidden_size=64,
                           intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=128)


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float, init: ParamInit):
        super().__init__()
        self.weight = init.ones(hidden_size)
        self.eps = eps

    def forward(self, x):
        return K.rms_norm(x, self.weight, epsilon=self.eps)


class LlamaRotaryEmbedding(nn.Module):
    """Precomputed float32 cos/sin tables ``[max_pos, head_dim]``. One
    instance is shared by every layer (the tables are equal), so they are
    held once on the device; ``state_dict`` still lists them per layer,
    as the reference does."""

    def __init__(self, head_dim: int, max_pos: int, theta: float,
                 device: torch.device):
        super().__init__()
        inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32,
                                            device=device) / head_dim))
        t = torch.arange(max_pos, dtype=torch.float32, device=device)
        freqs = torch.outer(t, inv)                      # [max_pos, dim/2]
        emb = torch.cat([freqs, freqs], dim=-1)          # [max_pos, dim]
        self.register_buffer("cos_cached", torch.cos(emb))
        self.register_buffer("sin_cached", torch.sin(emb))

    def forward(self):
        return self.cos_cached, self.sin_cached


def _position_ids(start_pos, b: int, s: int, device) -> torch.Tensor:
    """``[b, s]`` absolute positions: ``start_pos`` is a ``[b, s]``
    per-token matrix (a ragged step), a ``[b]`` per-row vector, or a
    scalar."""
    if isinstance(start_pos, torch.Tensor) and start_pos.dim() == 2:
        return start_pos
    steps = torch.arange(s, device=device, dtype=torch.int32)
    if isinstance(start_pos, torch.Tensor) and start_pos.dim() == 1:
        return start_pos.reshape(b, 1) + steps.reshape(1, s)
    return (steps + int(start_pos)).reshape(1, s).expand(b, s)


class LlamaAttention(nn.Module):
    """GQA attention. With a cache: rope at absolute positions, write into
    the cache, attend against everything written so far. Without: rope at
    ``position_ids`` and causal attention over the sequence."""

    def __init__(self, config: LlamaConfig, rotary: LlamaRotaryEmbedding,
                 init: ParamInit):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.q_proj = _linear(h, self.num_heads * self.head_dim, init)
        self.k_proj = _linear(h, self.num_kv_heads * self.head_dim, init)
        self.v_proj = _linear(h, self.num_kv_heads * self.head_dim, init)
        self.o_proj = _linear(self.num_heads * self.head_dim, h, init)
        self.rotary = rotary

    def forward(self, x, attn_mask=None, position_ids=None, cache=None,
                start_pos=None, layer_idx: int = 0):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        cos, sin = self.rotary()
        if cache is not None:
            q, k = K.rope(q, k, cos, sin,
                          _position_ids(start_pos, b, s, x.device))
            cache.update(layer_idx, k, v, start_pos)
            out = cache.attend(layer_idx, q, start_pos)
        else:
            if position_ids is None:
                position_ids = _position_ids(0, b, s, x.device)
            q, k = K.rope(q, k, cos, sin, position_ids)
            attend = K.flash_attention if self.config.use_flash_attention \
                else K.scaled_dot_product_attention
            out = attend(q, k, v, attn_mask=attn_mask, is_causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, init: ParamInit):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m, init)
        self.up_proj = _linear(h, m, init)
        self.down_proj = _linear(m, h, init)

    def forward(self, x):
        return self.down_proj(K.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, rotary: LlamaRotaryEmbedding,
                 init: ParamInit):
        super().__init__()
        self.self_attn = LlamaAttention(config, rotary, init)
        self.mlp = LlamaMLP(config, init)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size,
                                            config.rms_norm_eps, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, config.rms_norm_eps, init)

    def forward(self, x, attn_mask=None, position_ids=None, cache=None,
                start_pos=None, layer_idx: int = 0):
        x = x + self.self_attn(self.input_layernorm(x), attn_mask,
                               position_ids, cache=cache,
                               start_pos=start_pos, layer_idx=layer_idx)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(PaddleCall, nn.Module):
    """The decoder: a layer list, or with ``use_scan_layers`` one
    ``LayerStack`` (``layer_stack``, parameters ``stacked_{j}``), whose
    training forward runs each block over views of the stacked weights
    and whose cache forward raises, as the reference's does.
    ``recompute`` (training only) checkpoints each layer: ``True`` keeps
    the layer's input, ``"selective"`` also every matrix product's output
    (``dots_saveable``), and everything else, the flash forward included,
    runs again in the backward."""

    def __init__(self, config: LlamaConfig, init: ParamInit):
        super().__init__()
        self.config = config
        self.embed_tokens = _embedding(config.vocab_size,
                                       config.hidden_size, init)
        rotary = LlamaRotaryEmbedding(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta, init.device)
        if config.use_scan_layers:
            self.layer_stack = LayerStack(
                lambda: LlamaDecoderLayer(config, rotary, init),
                config.num_hidden_layers, remat=config.recompute)
        else:
            self.layers = nn.ModuleList(
                [LlamaDecoderLayer(config, rotary, init)
                 for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 init)

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                cache=None, start_pos=None):
        x = self.embed_tokens(input_ids)
        if cache is not None:
            if not hasattr(self, "layers"):
                raise NotImplementedError(
                    "KV-cache decode requires the unrolled layer list "
                    "(use_scan_layers stacks are a train-time layout)")
            for i, layer in enumerate(self.layers):
                x = layer(x, attn_mask, cache=cache, start_pos=start_pos,
                          layer_idx=i)
            return self.norm(x)
        if hasattr(self, "layer_stack"):
            return self.norm(self.layer_stack(x, attn_mask, position_ids))
        policy = dots_saveable if self.config.recompute == "selective" \
            else None
        for layer in self.layers:
            if self.config.recompute and self.training:
                x = recompute(layer, x, attn_mask, position_ids,
                              policy=policy)
            else:
                x = layer(x, attn_mask, position_ids)
        return self.norm(x)


class LlamaForCausalLM(PaddleCall, nn.Module, GenerationMixin):
    """Llama causal LM. ``device=None`` means the CUDA card (raises when
    there is none). Parameters are drawn normal(0, 0.02) from
    ``generator`` (default: a generator on ``device`` seeded 0); norm
    weights are ones. Load real or reference weights with
    ``models.convert.from_jax_state_dict``."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = ParamInit.make(device, config.dtype, generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = _linear(config.hidden_size, config.vocab_size,
                                   init)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                cache=None, start_pos=None):
        if cache is not None:   # serving: never an autograd graph
            with torch.no_grad():
                return self._logits(self.llama(
                    input_ids, attn_mask, cache=cache, start_pos=start_pos))
        return self._logits(self.llama(input_ids, attn_mask, position_ids))

    def _logits(self, hidden):
        if self.lm_head is None:  # tied: logits = h @ E^T
            return K.matmul(hidden, self.llama.embed_tokens.weight.T)
        return self.lm_head(hidden)


class LlamaPretrainingCriterion(PaddleCall, nn.Module):
    """Shifted next-token cross entropy: ``fused_softmax_ce(logits[:, :-1],
    labels[:, 1:]).mean()``, the mean over all positions (label -100
    counts as 0), as the reference takes it."""

    def __init__(self, config: Optional[LlamaConfig] = None):
        super().__init__()

    def forward(self, logits, labels):
        return K.mean(K.fused_softmax_ce(logits[:, :-1, :], labels[:, 1:]))
