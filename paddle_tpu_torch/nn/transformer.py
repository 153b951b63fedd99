"""Transformer building blocks: ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``.

Counterpart of ``paddle_tpu/nn/transformer.py:13-96``, copied as it is:
attention through ``call_op("scaled_dot_product_attention")`` (the
composite in both packages; its dropout draws from the port's generator
for the card, as the reference's draws a fresh key), a bool ``attn_mask``
keeps and a float one adds; the encoder layer's ``LayerNorm``s keep the
default epsilon 1e-5, ``attn_dropout`` / ``act_dropout`` of None mean
``dropout``, post-norm unless ``normalize_before``. ``TransformerEncoder``
deep-copies its layer, as the reference does, and gives each copy's
``Dropout``s generators of their own (a deep copy clones the generator's
state, where every reference dropout call draws a fresh key).
"""

from __future__ import annotations

import copy

from ..ops.dispatcher import call_op
from .layer_base import Layer
from .layers_common import Dropout, LayerList, LayerNorm, Linear, \
    reseed_dropouts

__all__ = ["MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        b, sq = query.shape[0], query.shape[1]
        sk = key.shape[1]
        q = self.q_proj(query).reshape([b, sq, self.num_heads, self.head_dim])
        k = self.k_proj(key).reshape([b, sk, self.num_heads, self.head_dim])
        v = self.v_proj(value).reshape([b, sk, self.num_heads, self.head_dim])
        out = call_op("scaled_dot_product_attention", q, k, v,
                      attn_mask=attn_mask,
                      dropout_p=self.dropout if self.training else 0.0)
        return self.out_proj(out.reshape([b, sq, self.embed_dim]))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        h = call_op(self.activation, self.linear1(src))
        src = self.linear2(self.dropout_act(h))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        copies = [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)]
        for layer in copies:
            reseed_dropouts(layer)
        self.layers = LayerList([encoder_layer] + copies)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
