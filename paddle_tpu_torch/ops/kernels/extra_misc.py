"""Round-2 tranche ops of ``paddle_tpu/ops/kernels/extra_misc.py``: so far
only ``top_p_sampling`` (:468, ``ops.yaml:619``), the sampling op the
serving slice brings. The rest of that module is queued (ROADMAP.md,
A5b).

``top_p_sampling`` is ``key: true`` in the reference; here its draw comes
from ``generator=``, by default the port's generator for the logits'
device (``core.generator``). The bits cannot match threefry's: the op
matches the reference by support, shape, dtype and the top-p cut.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.generator import generator_for
from ..dispatcher import register_kernel


@register_kernel("top_p_sampling")
def top_p_sampling(x: torch.Tensor, ps: torch.Tensor, threshold=None,
                   generator: Optional[torch.Generator] = None):
    """Per-row nucleus sampling: x ``[B, V]`` logits, ps ``[B]`` each row's
    p. Keeps the smallest set of the highest logits whose probability
    reaches p (at least one), draws one id a row from it. Returns
    ``(ids [B, 1] int64, scores [B, 1] float32)``, the score being the
    drawn id's softmax probability over all the logits. ``threshold`` is
    accepted and unused, as in the reference."""
    logits = x.float()
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
    cut_idx = (cum < ps.float().reshape(-1, 1)).sum(dim=-1, keepdim=True)
    # the reference's gather clamps an index past the end (p = 1.0 with a
    # cumulative sum that rounds below it)
    cutoff = torch.gather(sorted_l, -1,
                          cut_idx.clamp(max=logits.shape[-1] - 1))
    filt = logits.masked_fill(logits < cutoff, float("-inf"))
    g = generator_for(logits.device, generator)
    ids = torch.multinomial(torch.softmax(filt, dim=-1), 1, generator=g)
    scores = torch.gather(torch.softmax(logits, dim=-1), -1, ids)
    return ids.to(torch.int64), scores
