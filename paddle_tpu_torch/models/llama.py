"""Llama model family: the serving and the training forward.

Counterpart of ``paddle_tpu/models/llama.py``: the same modules, names and
parameter layouts, so a JAX ``state_dict()`` maps onto this one name for
name (``models/convert.py``). Linear weights stay ``[in, out]`` (Paddle's
layout: ``x @ W``). Parameters are trainable, as in the reference.

Under tensor parallelism (``fleet.init`` with ``mp_degree > 1``) the
model is built cut, where the reference switches (:68-100, :244-250,
:311-315): q/k/v and gate/up are ``ColumnParallelLinear``s, o_proj and
down ``RowParallelLinear``s, the embedding ``VocabParallelEmbedding``,
``lm_head`` column-parallel with ``gather_output=True`` (the criterion
is unchanged), and each rank's attention runs the flash kernels on its
own heads (``ops/kernels/tp_attention.py``). Where the head counts do not
cut over the ranks, q/k/v stay whole and every rank runs the flash
kernels on all the heads, recorded as the reference's fallback (the
reference takes its composite there; ROADMAP.md §C). Load cut
weights with ``models.convert.shard_state_dict``. The cache forward
raises under tensor parallelism (ROADMAP.md A8(f)).

Under sequence parallelism (fleet's ``sep_degree > 1``, the reference's
:192-195) each sep rank holds a contiguous chunk of the sequence
(``fleet.distributed_model``'s ``SegmentParallel`` cuts the inputs):
rope runs at the global positions (``sep_rank * s/sep + i``), attention
is ``ring_attention`` over the sep group, and the criterion's shift
crosses the shards: a rank's last position takes the next rank's first
label, the last rank drops its last position, and the mean runs over all
``b * (s - 1)`` positions (an all-reduce over sep of the sum; each rank's
grad is its own positions', which the dp x sep mean of the grads makes
the whole mean's).

Under the pipeline (``pp_degree > 1``, the reference's :252-290) each
stage builds only its part: its rows of the ``LayerStack`` (``S * v``
chunks of equal rows, chunk c on stage ``c % S``), the embedding on stage
0, the norm and the head on the last stage, where the reference keeps
them outside the pipeline, replicated (ROADMAP.md §C).
``fleet.distributed_model`` wraps it in ``PipelineParallel``, whose
``train_batch`` runs ``pipeline_forward`` / ``pipeline_loss`` by the
schedule; ``forward`` itself raises there. ``pipeline_rows`` tells
``shard_state_dict`` the stage's rows.

Two forwards:

- with a cache (serving): each layer writes its K/V into the cache and
  attends through it (the paged kernels, or the contiguous cache's
  composite), passing ``attn_mask`` on as the reference does (:186). It
  runs under ``no_grad``, so it never builds an autograd graph;
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
from ..ops.kernels import tp_attention as _tpa
from .generation import GenerationMixin


def _linear(in_features: int, out_features: int, init: ParamInit,
            col: Optional[bool] = None, gather_output: bool = False,
            input_is_parallel: bool = True):
    """A bias-free linear drawn from the model's ``ParamInit``: under
    tensor parallelism (``_tp_degree() > 1``) a ``ColumnParallelLinear``
    (``col=True``) or a ``RowParallelLinear`` (``col=False``), where the
    reference switches (:91-101); a ``Linear`` otherwise, or with
    ``col=None``."""
    if col is not None and _tp_degree() > 1:
        from ..distributed.fleet.mp_layers import (ColumnParallelLinear,
                                                   RowParallelLinear)
        if col:
            return ColumnParallelLinear(in_features, out_features,
                                        weight_attr=init.attr(),
                                        has_bias=False,
                                        gather_output=gather_output)
        return RowParallelLinear(in_features, out_features,
                                 weight_attr=init.attr(), has_bias=False,
                                 input_is_parallel=input_is_parallel)
    return Linear(in_features, out_features, weight_attr=init.attr(),
                  bias_attr=False)


def _hcg():
    from ..distributed.topology import get_hybrid_communicate_group
    return get_hybrid_communicate_group()


def _tp_degree() -> int:
    """The model-parallel degree of fleet's topology (1 without one)."""
    hcg = _hcg()
    return 1 if hcg is None else hcg.get_model_parallel_world_size()


def _sep_group():
    """The sep group under sequence parallelism, else None."""
    hcg = _hcg()
    if hcg is None or hcg.get_sep_parallel_world_size() <= 1:
        return None
    return hcg.get_sep_parallel_group()


def _pipe_layout():
    """``(stages, this stage, virtual stages a stage)``; (1, 0, 1) off the
    pipeline."""
    hcg = _hcg()
    if hcg is None or hcg.get_pipe_parallel_world_size() <= 1:
        return 1, 0, 1
    from ..distributed.fleet import get_strategy
    st = get_strategy()
    v = 1 if st is None else int(
        st.pipeline_configs.get("virtual_pp_degree", 1) or 1)
    return hcg.get_pipe_parallel_world_size(), hcg.get_stage_id(), v


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
        h, d = config.hidden_size, self.head_dim
        tp = _tp_degree()
        self.tp_reason = None if tp == 1 else \
            _tpa.tp_reason(tp, self.num_heads, self.num_kv_heads)
        # under TP the projections cut the heads over the ranks; where
        # the head counts do not cut, q/k/v stay whole on every rank
        # (head-replicated) and o_proj takes this rank's slice
        col = None if self.tp_reason is not None else True
        self.q_proj = _linear(h, self.num_heads * d, init, col)
        self.k_proj = _linear(h, self.num_kv_heads * d, init, col)
        self.v_proj = _linear(h, self.num_kv_heads * d, init, col)
        self.o_proj = _linear(self.num_heads * d, h, init, col=False,
                              input_is_parallel=self.tp_reason is None)
        cut = tp if self.tp_reason is None else 1
        self.local_heads = self.num_heads // cut
        self.local_kv_heads = self.num_kv_heads // cut
        self.rotary = rotary

    def forward(self, x, attn_mask=None, position_ids=None, cache=None,
                start_pos=None, layer_idx: int = 0):
        b, s, _ = x.shape
        hq, hk, d = self.local_heads, self.local_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, hq, d)
        k = self.k_proj(x).reshape(b, s, hk, d)
        v = self.v_proj(x).reshape(b, s, hk, d)
        cos, sin = self.rotary()
        if cache is not None:
            if _tp_degree() > 1:
                raise NotImplementedError(
                    "serving under tensor parallelism is ROADMAP.md A8(f)")
            q, k = K.rope(q, k, cos, sin,
                          _position_ids(start_pos, b, s, x.device))
            cache.update(layer_idx, k, v, start_pos)
            out = cache.attend(layer_idx, q, start_pos, attn_mask)
        else:
            sep = _sep_group()
            if position_ids is None:      # global positions under sep
                start = 0 if sep is None else sep.rank * s
                position_ids = _position_ids(start, b, s, x.device)
            q, k = K.rope(q, k, cos, sin, position_ids)
            attend = K.flash_attention if self.config.use_flash_attention \
                else K.scaled_dot_product_attention
            if sep is not None:
                # the reference's ring_attention op (:192-195): the local
                # heads, or every head under the head-replicated fallback
                ring = lambda: K.ring_attention(  # noqa: E731
                    q, k, v, is_causal=True)
                if self.tp_reason is None:
                    out = ring()
                else:
                    with _tpa.head_replicated():
                        out = ring()
            elif self.tp_reason is None:
                out = attend(q, k, v, attn_mask=attn_mask, is_causal=True)
            else:
                # recorded as the reference's composite fallback; the
                # kernels still run, on every head
                _tpa.record_fallback("flash", *self.tp_reason)
                with _tpa.head_replicated():
                    out = attend(q, k, v, attn_mask=attn_mask,
                                 is_causal=True)
        return self.o_proj(out.reshape(b, s, hq * d))


class LlamaMLP(nn.Module):
    """SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, init: ParamInit):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m, init, col=True)
        self.up_proj = _linear(h, m, init, col=True)
        self.down_proj = _linear(m, h, init, col=False)

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
        S, stage, v = _pipe_layout()
        self.embed_tokens = None
        if stage == 0:
            if _tp_degree() > 1:
                from ..distributed.fleet.mp_layers import \
                    VocabParallelEmbedding
                self.embed_tokens = VocabParallelEmbedding(
                    config.vocab_size, config.hidden_size,
                    weight_attr=init.attr())
            else:
                self.embed_tokens = _embedding(config.vocab_size,
                                               config.hidden_size, init)
        rotary = LlamaRotaryEmbedding(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta, init.device)
        if S > 1:
            L = config.num_hidden_layers
            if L % (S * v):
                raise ValueError(f"{L} layers do not cut into {S} stages x "
                                 f"{v} virtual stages")
            self.layer_stack = LayerStack(
                lambda: LlamaDecoderLayer(config, rotary, init), L // S,
                remat=config.recompute)
        elif config.use_scan_layers:
            self.layer_stack = LayerStack(
                lambda: LlamaDecoderLayer(config, rotary, init),
                config.num_hidden_layers, remat=config.recompute)
        else:
            self.layers = nn.ModuleList(
                [LlamaDecoderLayer(config, rotary, init)
                 for _ in range(config.num_hidden_layers)])
        self.norm = None
        if stage == S - 1:
            self.norm = LlamaRMSNorm(config.hidden_size,
                                     config.rms_norm_eps, init)

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
        S, stage, v = _pipe_layout()
        if S > 1 and config.tie_word_embeddings:
            raise NotImplementedError("tied embeddings under the pipeline "
                                      "(a SharedLayerDesc in a "
                                      "PipelineLayer)")
        self.llama = LlamaModel(config, init)
        self.lm_head = None
        if not config.tie_word_embeddings and stage == S - 1:
            self.lm_head = _linear(config.hidden_size, config.vocab_size,
                                   init, col=True, gather_output=True)
        self._pipe = (S, stage, v)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- the pipeline's stage (pp > 1) ----------------------------------------
    def pipeline_chunks(self) -> int:
        return self._pipe[2]

    @property
    def pipeline_rows(self):
        """``{stacked parameter name: the full stack's rows this stage
        holds}`` under the pipeline, else None."""
        S, stage, v = self._pipe
        if S == 1:
            return None
        nl = self.config.num_hidden_layers // (S * v)
        rows = [(j * S + stage) * nl + i for j in range(v)
                for i in range(nl)]
        return {f"llama.layer_stack.{n}": rows for n, _ in
                self.llama.layer_stack.named_parameters()}

    def pipeline_forward(self, x, chunk: int):
        """Local chunk ``chunk`` of this stage: ids -> embedding first on
        global chunk 0, the chunk's decoder rows, norm and head -> logits
        after the last."""
        S, stage, v = self._pipe
        c = chunk * S + stage
        nl = self.config.num_hidden_layers // (S * v)
        if c == 0:
            x = self.llama.embed_tokens(x)
        x = self.llama.layer_stack.run(x, chunk * nl, (chunk + 1) * nl,
                                       None, None)
        if c == S * v - 1:
            x = self._logits(self.llama.norm(x))
        return x

    def pipeline_loss(self, logits, labels):
        return LlamaPretrainingCriterion(self.config)(logits, labels)

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                cache=None, start_pos=None):
        if self._pipe[0] > 1:
            raise RuntimeError("under the pipeline the model runs through "
                               "fleet.distributed_model(model).train_batch "
                               "/ .eval_batch")
        if cache is not None:   # serving: never an autograd graph
            with torch.no_grad():
                return self._logits(self.llama(
                    input_ids, attn_mask, cache=cache, start_pos=start_pos))
        return self._logits(self.llama(input_ids, attn_mask, position_ids))

    def _logits(self, hidden):
        if self.lm_head is None:  # tied: logits = h @ E^T
            emb = self.llama.embed_tokens
            if _tp_degree() > 1:   # this rank's vocab rows, then gathered
                from ..distributed.fleet import mp_layers as mp
                return mp.gather_from_mp(K.matmul(
                    mp.copy_to_mp(hidden, emb.group), emb.weight.T),
                    emb.group)
            return K.matmul(hidden, emb.weight.T)
        return self.lm_head(hidden)


class LlamaPretrainingCriterion(PaddleCall, nn.Module):
    """Shifted next-token cross entropy: ``fused_softmax_ce(logits[:, :-1],
    labels[:, 1:]).mean()``, the mean over all positions (label -100
    counts as 0), as the reference takes it. Under sequence parallelism
    the logits are this sep rank's chunk and ``labels`` its chunk or the
    whole sequence; the shift crosses the shards (module docstring)."""

    def __init__(self, config: Optional[LlamaConfig] = None):
        super().__init__()

    def forward(self, logits, labels):
        sep = _sep_group()
        if sep is None:
            return K.mean(K.fused_softmax_ce(logits[:, :-1, :],
                                             labels[:, 1:]))
        b, sl = logits.shape[:2]
        n, r = sep.nranks, sep.rank
        if labels.shape[1] == sl * n:           # the whole sequence
            nxt = labels[:, r * sl + 1:(r + 1) * sl + 1]
        elif labels.shape[1] == sl:             # this rank's chunk
            from ..distributed import collective as C
            heads = C.all_gather([], labels[:, :1].contiguous(), group=sep)
            nxt = labels[:, 1:] if r == n - 1 else \
                torch.cat([labels[:, 1:], heads[r + 1]], dim=1)
        else:
            raise ValueError(f"labels of length {labels.shape[1]} for "
                             f"logits of {sl} positions over {n} sep ranks")
        mine = logits if r < n - 1 else logits[:, :-1, :]
        total = K.fused_softmax_ce(mine, nxt).float().sum()
        from ..distributed.fleet import mp_layers as mp
        # every rank's objective is the sum: its part gets every grad
        return mp.all_reduce(total, sep, sum_grads=True) \
            / float(b * (sl * n - 1))
