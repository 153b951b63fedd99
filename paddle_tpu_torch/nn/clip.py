"""Gradient clipping.

Counterpart of ``paddle_tpu/nn/clip.py``: ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` (:52-83). A clip takes a
list of ``(param, grad)`` pairs and returns a new one; the grads it is
given are not changed. Every reduction stays on the device: nothing here
syncs with the host.

``global_norm_coeff`` is the global-norm clip's coefficient
``min(clip / max(sqrt(sum |g|^2), 1e-12), 1)`` in float32. The optimizer's
fused route folds it into its kernel instead of rewriting the grads, and
the per-parameter route multiplies by the same coefficient, so the two
agree bit for bit.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

PairList = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def sum_of_squares(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sum_i sum(g_i^2)`` in float32, one reduction per grad, in order."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


def global_norm_coeff(grads: Iterable[torch.Tensor], clip_norm: float
                      ) -> torch.Tensor:
    """The global-norm clip coefficient, a float32 device scalar. ``grads``
    may be a generator (one temporary at a time)."""
    gnorm = torch.sqrt(sum_of_squares(grads))
    clip = torch.full((), clip_norm, dtype=torch.float32, device=gnorm.device)
    return torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)


class ClipGradBase:
    def __call__(self, params_grads: PairList) -> PairList:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every grad element into ``[min, max]`` (min defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads: PairList) -> PairList:
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Per-tensor norm clip, the scale taken in float32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads: PairList) -> PairList:
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.linalg.vector_norm(g.float())
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Global-norm clip across every grad: each is multiplied by
    :func:`global_norm_coeff`, cast to its dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def coeff(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return global_norm_coeff(grads, self.clip_norm)

    def __call__(self, params_grads: PairList) -> PairList:
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        c = self.coeff(grads)
        return [(p, g if g is None else g * c.to(g.dtype))
                for p, g in params_grads]
