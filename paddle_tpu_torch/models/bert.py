"""BERT: ``BertConfig`` (``.base()``, ``.tiny()``), ``BertModel``,
``BertForQuestionAnswering`` (the SQuAD span head) and
``BertForSequenceClassification``.

Counterpart of ``paddle_tpu/models/bert.py:21-139`` (PaddleNLP's BERT on
``nn.TransformerEncoder``), with the same parameter names
(``encoder.layers.{i}.*``), so ``models.from_jax_state_dict`` loads a
reference model name for name. ``BertModel.forward`` turns a ``[b, s]``
padding mask into the additive float32 ``[b, 1, 1, s]`` mask ``(1 - m) ·
-1e9``; ``position_ids`` and ``token_type_ids`` default to ``arange`` and
zeros on the input's device. The encoder's attention is the composite
``scaled_dot_product_attention`` op, with its probability dropout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..nn.layer_base import Layer
from ..ops.dispatcher import call_op


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          max_position_embeddings=128)


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings,
                                                config.hidden_size)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size,
                                                  config.hidden_size)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, hidden):
        return call_op("tanh", self.dense(hidden[:, 0]))


class BertModel(Layer):
    def __init__(self, config: BertConfig, add_pooler: bool = True):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        enc_layer = nn.TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            act_dropout=0.0)  # BERT has no intermediate-activation dropout
        # (PaddleNLP BertModel passes act_dropout=0; the layer default
        # of act_dropout=dropout added 12 masks on the largest [B,S,4H]
        # activations — a measured ~2ms/step at b8 s384)
        self.encoder = nn.TransformerEncoder(enc_layer,
                                             config.num_hidden_layers)
        self.pooler = BertPooler(config) if add_pooler else None

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # [b, s] padding mask -> additive [b, 1, 1, s]
            m = attention_mask.to(torch.float32)
            attention_mask = (1.0 - m[:, None, None, :]) * -1e9
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(x, src_mask=attention_mask)
        pooled = self.pooler(seq) if self.pooler is not None else None
        return seq, pooled


class BertForQuestionAnswering(Layer):
    """SQuAD head: start/end span logits (config 2's fine-tune target)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.bert = BertModel(config, add_pooler=False)
        self.classifier = nn.Linear(config.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, position_ids,
                           attention_mask)
        logits = self.classifier(seq)
        start, end = call_op("split", logits, 2, axis=-1)
        return start.squeeze(-1), end.squeeze(-1)


class BertForSequenceClassification(Layer):
    def __init__(self, config: BertConfig, num_classes: int = 2):
        super().__init__()
        self.bert = BertModel(config)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))
