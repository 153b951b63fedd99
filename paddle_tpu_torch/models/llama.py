"""Llama model family, the serving path.

Counterpart of ``paddle_tpu/models/llama.py``: the same modules, names and
parameter layouts, so a JAX ``state_dict()`` maps onto this one name for
name (``models/convert.py``). Linear weights stay ``[in, out]`` (Paddle's
layout: ``x @ W``).

Only the unsharded KV-cache path is ported: each layer writes its K/V into
the cache and attends through it (the paged kernels). The no-cache forward
needs the flash-attention kernel, which belongs to a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..core.device import DeviceLike, dtype_of, resolve_device
from ..ops.kernels import nn as K
from .generation import GenerationMixin


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


class _Init:
    """Where and how parameters are made: device, dtype, and the explicit
    generator their normal(0, std) draws come from."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator, std: float = 0.02):
        self.device, self.dtype = device, dtype
        self.generator, self.std = generator, std

    def normal(self, *shape) -> nn.Parameter:
        w = torch.empty(*shape, device=self.device, dtype=self.dtype)
        w.normal_(0.0, self.std, generator=self.generator)
        return nn.Parameter(w, requires_grad=False)

    def ones(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(*shape, device=self.device,
                                       dtype=self.dtype),
                            requires_grad=False)


class Linear(nn.Module):
    """``x @ W`` with ``W [in, out]`` (the JAX package's ``nn.Linear``)."""

    def __init__(self, in_features: int, out_features: int, init: _Init):
        super().__init__()
        self.weight = init.normal(in_features, out_features)

    def forward(self, x):
        return K.linear(x, self.weight)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, dim: int, init: _Init):
        super().__init__()
        self.weight = init.normal(num_embeddings, dim)

    def forward(self, ids):
        return K.embedding(ids, self.weight)


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float, init: _Init):
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
    """GQA attention over the KV cache: rope at absolute positions, write
    into the cache, attend against everything written so far."""

    def __init__(self, config: LlamaConfig, rotary: LlamaRotaryEmbedding,
                 init: _Init):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.q_proj = Linear(h, self.num_heads * self.head_dim, init)
        self.k_proj = Linear(h, self.num_kv_heads * self.head_dim, init)
        self.v_proj = Linear(h, self.num_kv_heads * self.head_dim, init)
        self.o_proj = Linear(self.num_heads * self.head_dim, h, init)
        self.rotary = rotary

    def forward(self, x, cache=None, start_pos=None, layer_idx: int = 0):
        if cache is None:
            raise NotImplementedError(
                "the no-cache forward needs the flash-attention kernel "
                "(ROADMAP.md, B1 flash_attention.py), which is not ported "
                "yet; serve through a cache (the engine or "
                "generate(cache_type='paged'))")
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        cos, sin = self.rotary()
        q, k = K.rope(q, k, cos, sin,
                      _position_ids(start_pos, b, s, x.device))
        cache.update(layer_idx, k, v, start_pos)
        out = cache.attend(layer_idx, q, start_pos)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = Linear(h, m, init)
        self.up_proj = Linear(h, m, init)
        self.down_proj = Linear(m, h, init)

    def forward(self, x):
        return self.down_proj(K.swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, rotary: LlamaRotaryEmbedding,
                 init: _Init):
        super().__init__()
        self.self_attn = LlamaAttention(config, rotary, init)
        self.mlp = LlamaMLP(config, init)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size,
                                            config.rms_norm_eps, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            config.hidden_size, config.rms_norm_eps, init)

    def forward(self, x, cache=None, start_pos=None, layer_idx: int = 0):
        x = x + self.self_attn(self.input_layernorm(x), cache=cache,
                               start_pos=start_pos, layer_idx=layer_idx)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      init)
        rotary = LlamaRotaryEmbedding(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta, init.device)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, rotary, init)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps,
                                 init)

    def forward(self, input_ids, cache=None, start_pos=None):
        x = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            x = layer(x, cache=cache, start_pos=start_pos, layer_idx=i)
        return self.norm(x)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Llama causal LM. ``device=None`` means the CUDA card (raises when
    there is none). Parameters are drawn normal(0, 0.02) from
    ``generator`` (default: a generator on ``device`` seeded 0); norm
    weights are ones. Load real or reference weights with
    ``models.convert.from_jax_state_dict``."""

    def __init__(self, config: LlamaConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init = _Init(device, dtype_of(config.dtype), generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = None
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  init)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def forward(self, input_ids, cache=None, start_pos=None):
        hidden = self.llama(input_ids, cache=cache, start_pos=start_pos)
        if self.lm_head is None:  # tied: logits = h @ E^T
            return torch.matmul(hidden, self.llama.embed_tokens.weight.T)
        return self.lm_head(hidden)
