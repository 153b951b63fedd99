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
agree bit for bit. Both ask the clip object for it
(``ClipGradByGlobalNorm.coeff(grads, params)``), so a model-parallel clip
(``distributed.fleet.HybridParallelClipGrad``) can sum the squared norms
over its ranks.
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
    return norm_coeff(sum_of_squares(grads), clip_norm)


def norm_coeff(sq: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(clip / max(sqrt(sq), 1e-12), 1)`` of a float32 device
    scalar ``sq``, the sum of the squared grads."""
    gnorm = torch.sqrt(sq)
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

    def sum_of_squares(self, grads: Iterable[torch.Tensor],
                       params: Optional[Sequence[torch.Tensor]] = None
                       ) -> torch.Tensor:
        """``sum |g|^2`` over ``grads`` (the grads of ``params``, which a
        model-parallel clip reads)."""
        return sum_of_squares(grads)

    def coeff(self, grads: Iterable[torch.Tensor],
              params: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
        return norm_coeff(self.sum_of_squares(grads, params), self.clip_norm)

    def __call__(self, params_grads: PairList) -> PairList:
        pairs = [(p, g) for p, g in params_grads if g is not None]
        if not pairs:
            return params_grads
        c = self.coeff([g for _, g in pairs], [p for p, _ in pairs])
        return [(p, g if g is None else g * c.to(g.dtype))
                for p, g in params_grads]
