"""Activation recomputation.

Counterpart of ``paddle_tpu/distributed/recompute.py:26-68``:
``recompute(function, *args, policy=None, **kwargs)`` runs ``function``
so that what it saves for the backward is dropped and recomputed there,
and ``recompute_sequential`` chains segments. It is
``torch.utils.checkpoint.checkpoint`` (non-reentrant) where the
reference is ``jax.checkpoint``; a ``policy`` makes it selective through
``create_selective_checkpoint_contexts``. :func:`dots_saveable` is the
counterpart of ``jax.checkpoint_policies.dots_saveable``: the outputs of
matrix products (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``) are kept,
everything else is recomputed. The port's CUDA kernels (flash attention)
run inside ``torch.autograd.Function``s whose launch the policy never
sees: their own aten ops (the ``empty`` outputs, views) are recomputed,
so the recompute runs the Function again and its saved tensors are the
recompute's, never a stale cache.

Deliberate differences from the reference:

- the reference passes eager calls through and checkpoints only under a
  trace (``jax.checkpoint`` needs one); the port has no such split and
  always checkpoints;
- it is always non-reentrant, whatever ``use_reentrant`` says;
- torch's RNG state is not saved (``preserve_rng_state=False``: reading
  the CUDA generator's state fails inside a CUDA-graph capture, and the
  port's layers draw from explicit generators only). Instead the explicit
  generators of the segment (``generators=``, by default those of the
  ``Dropout`` layers under ``function`` when it is a module) are rewound
  to their state at the segment's start for the recompute and put back
  after it, so the recompute draws the forward's masks, as the
  reference's explicitly keyed PRNG does.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
_DOTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}


def dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the outputs of matrix products; recompute everything else."""
    if getattr(op, "overloadpacket", op) in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def module_generators(function) -> List[torch.Generator]:
    """The explicit generators of the layers under ``function`` (a
    module's ``generator`` attributes), each once."""
    if not isinstance(function, torch.nn.Module):
        return []
    out: List[torch.Generator] = []
    for m in function.modules():
        g = getattr(m, "generator", None)
        if isinstance(g, torch.Generator) and all(g is not o for o in out):
            out.append(g)
    return out


def _replaying(function: Callable, gens: Sequence[torch.Generator]):
    """``function`` whose second and later runs (the recomputes) start
    from the generators' state at its first run, and leave them as they
    found them."""
    start: List = []

    def run(*args, **kwargs):
        if not start:
            start.extend(g.get_state() for g in gens)
            return function(*args, **kwargs)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            return function(*args, **kwargs)
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)
    return run


def recompute(function: Callable, *args, use_reentrant: bool = True,
              policy: Optional[Callable] = None,
              generators: Optional[Sequence[torch.Generator]] = None,
              **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward; under ``policy`` (e.g. :func:`dots_saveable`) only what the
    policy does not keep. ``use_reentrant`` is accepted and ignored."""
    gens = module_generators(function) if generators is None \
        else list(generators)
    fn = _replaying(function, gens) if gens else function
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   policy) if policy is not None else None
    extra = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **extra, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Chain ``functions``, each segment recomputed (``ctx`` is accepted
    for the reference's API)."""
    out = None
    for i, fn in enumerate(functions):
        if i == 0:
            out = recompute(fn, *args, **kwargs)
        else:
            out = recompute(fn, *out) if isinstance(out, tuple) \
                else recompute(fn, out)
    return out
