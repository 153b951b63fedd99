"""Common layers: ``Linear`` and ``Embedding``.

Counterpart of the ``Linear`` and ``Embedding`` of
``paddle_tpu/nn/layers_common.py``, cut to what the Llama and MoE models
use: no bias, weights drawn from a :class:`ParamInit`. ``Linear`` keeps
Paddle's ``[in, out]`` weight layout (``x @ W``), so a JAX ``state_dict``
maps onto the port name for name. ``nn/quant.py`` swaps ``Linear``s for
``WeightOnlyLinear``s.
"""

from __future__ import annotations

from torch import nn

from ..ops.kernels import nn as K
from .initializer import ParamInit


class Linear(nn.Module):
    """``x @ W`` with ``W [in, out]`` (the JAX package's ``nn.Linear``)."""

    def __init__(self, in_features: int, out_features: int, init: ParamInit):
        super().__init__()
        self.weight = init.normal(in_features, out_features)

    def forward(self, x):
        return K.linear(x, self.weight)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, dim: int, init: ParamInit):
        super().__init__()
        self.weight = init.normal(num_embeddings, dim)

    def forward(self, ids):
        return K.embedding(ids, self.weight)
