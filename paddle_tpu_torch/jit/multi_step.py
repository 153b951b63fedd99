"""Multi-step capture: K whole training steps in ONE CUDA graph.

Counterpart of ``paddle_tpu/jit/multi_step.py``: ``MultiStepCapture``,
the frozen ``MULTI_STEP_FALLBACK_REASONS`` (:60, equal to the
reference's), ``multi_counters`` and ``record_block_fallback``. The
reference scans the single-step body K times in one executable; here the
single-step body is captured K times in a row into one graph, lane k
reading slice k of ``[K, ...]``-stacked static input buffers
(``io.DataLoader.fill_ring`` stacks the batches).

- Before lane k's optimizer step the lr is copied, inside the graph, from
  a ``[K]`` device stack into the optimizer's lr scalar. The stack is
  filled before each block (outside the graph) by advancing a shadow copy
  of the host scheduler K times, as the reference does. The step scalar
  is the device counter the graph advances lane by lane.
- The host effects (optimizer step-count deltas, no-arg scheduler
  advances, launch counts) are applied K times per block.
- The graph's private pool reuses memory across the K bodies: lane k's
  activations are freed before lane k+1 allocates, so a block's pool
  holds about one step's worth, not K (``graphs()`` gives each
  capture's pool bytes).
- Outputs come back ``[K]``-stacked (tensors stacked; Python numbers as a
  tensor; other values as a per-lane list).

The first block probes on its first step and runs the other K-1 eagerly;
the second warms up (K eager steps over the static block, this call's
result) and captures; every later block replays. Blocks that cannot run
multi-step fall back to K eager steps, with the single-step reasons of
``step_capture.FALLBACK_REASONS`` or the block reasons here; epoch tails
shorter than K are the caller's (``hapi.Model.fit`` runs them through
single-step capture and counts them in ``multi_counters["tail_steps"]``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
from torch.utils import _pytree as pytree

from .step_capture import (CapturedStep, FALLBACK_REASONS, _CaptureCtx,
                           _Entry, _HostSnapshot, _param_device)

__all__ = ["MultiStepCapture", "MULTI_STEP_FALLBACK_REASONS",
           "multi_counters", "record_block_fallback"]

MULTI_STEP_FALLBACK_REASONS = frozenset({
    "FLAGS_multi_step disabled",
    "ring block shorter than k_steps (epoch tail)",
    "per-step host callbacks need single-step dispatch",
    "multi-step block skipped inside a rewind poison window",
})

multi_counters = {"blocks": 0, "replays": 0, "fallbacks": 0,
                  "tail_steps": 0}


def record_block_fallback(reason: str, detail=None) -> None:
    """Count a block-level fallback decided outside a capture object (the
    fit loop declining the multi-step path). ``reason`` must be a member
    of ``MULTI_STEP_FALLBACK_REASONS``."""
    if reason not in MULTI_STEP_FALLBACK_REASONS:
        raise ValueError(f"unregistered multi_step fallback reason "
                         f"{reason!r}: add it to MULTI_STEP_FALLBACK_REASONS")
    multi_counters["fallbacks"] += 1


def _split_block(args, kwargs, k: int):
    """K per-step ``(args, kwargs)`` from a ``[K, ...]``-stacked block.
    Raises on a tensor whose leading axis is not K (a malformed block is
    the caller's bug, not a fallback)."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and tuple(leaf.shape[:1]) != (k,):
            raise ValueError(
                f"multi-step block: every tensor needs a leading [K={k}] "
                f"step axis, got shape {tuple(leaf.shape)}: stack K batches "
                f"(io.DataLoader.fill_ring) before the call")
    return [pytree.tree_unflatten(
        [x[i] if isinstance(x, torch.Tensor) else x for x in leaves], spec)
        for i in range(k)]


def _stack_outputs(outs: List[Any]):
    """K per-step output trees stacked into one ``[K]`` tree."""
    flats = [pytree.tree_flatten(o) for o in outs]
    leaves0, spec = flats[0]
    stacked = []
    for j in range(len(leaves0)):
        col = [f[0][j] for f in flats]
        if isinstance(col[0], torch.Tensor):
            stacked.append(torch.stack(col))
        elif isinstance(col[0], (bool, int, float)):
            stacked.append(torch.tensor(col))
        else:
            stacked.append(col)
    return pytree.tree_unflatten(stacked, spec)


class MultiStepCapture(CapturedStep):
    """K-step block capture: each call takes a ``[K, ...]``-stacked batch
    block and runs K whole steps; a block is equivalent to K single-step
    replays (same lr per step, same device step counter, same host
    effects)."""

    def __init__(self, fn, k_steps: int,
                 generators: Sequence[torch.Generator] = (), **kw):
        if int(k_steps) < 2:
            raise ValueError(f"k_steps must be >= 2, got {k_steps} (use "
                             f"jit_step(fn) for single-step capture)")
        super().__init__(fn, generators=generators, **kw)
        self.k_steps = int(k_steps)

    # -- fallbacks -----------------------------------------------------------
    def _fallback(self, reason, detail=None):
        if reason in MULTI_STEP_FALLBACK_REASONS:
            multi_counters["fallbacks"] += 1
            self._last_reason = reason if detail is None \
                else f"{reason}: {detail}"
            return
        if reason in FALLBACK_REASONS:
            multi_counters["fallbacks"] += 1
        super()._fallback(reason, detail)

    # -- eager paths ---------------------------------------------------------
    def _eager(self, args, kwargs):
        return _stack_outputs([self._fn(*a, **kw) for a, kw in
                               _split_block(args, kwargs, self.k_steps)])

    def _probe(self, args, kwargs, arg_sig, dyn):
        # probe on step 0's slice; the block's other K-1 steps run eagerly
        # so the caller still gets K trained steps back
        steps = _split_block(args, kwargs, self.k_steps)
        a0, k0 = steps[0]
        lane0 = [t[0] for t in dyn]
        outs = [self._probe_and_prime(a0, k0, arg_sig, lane0)]
        outs += [self._fn(*a, **kw) for a, kw in steps[1:]]
        return _stack_outputs(outs)

    # -- the K-lane body -------------------------------------------------------
    def _lr_columns(self, d) -> List[List[float]]:
        """Each optimizer's lr at each of the block's K steps: a shadow
        copy of the host scheduler advanced K times, then rolled back."""
        k = self.k_steps
        if not d.sched_deltas:
            return [[float(o.get_lr())] * k for o in d.opts]
        snap = _HostSnapshot(d)
        cols: List[List[float]] = [[] for _ in d.opts]
        try:
            for _ in range(k):
                for i, o in enumerate(d.opts):
                    cols[i].append(float(o.get_lr()))
                for sref, delta in d.sched_deltas:
                    s = sref()
                    if s is not None:
                        for _ in range(delta):
                            s.step()
        finally:
            snap.restore()
        return cols

    def _setup_entry(self, entry: _Entry) -> None:
        d = entry.disc
        for o in d.opts:
            entry.lr_stacks[id(o)] = torch.zeros(
                self.k_steps, dtype=torch.float32, device=_param_device(o))
        self._fill_stacks(entry)

    def _fill_stacks(self, entry: _Entry) -> None:
        d = entry.disc
        entry.cols = self._lr_columns(d)
        for o, col in zip(d.opts, entry.cols):
            entry.lr_stacks[id(o)].copy_(torch.tensor(col,
                                                      dtype=torch.float32))

    def _before_replay(self, entry: _Entry) -> None:
        self._fill_stacks(entry)

    def _after_replay(self, entry: _Entry) -> None:
        multi_counters["blocks"] += 1
        multi_counters["replays"] += 1
        for o in entry.disc.opts:
            o._stale_live("lr")     # the graph wrote lane K-1's lr

    def _host_reps(self) -> int:
        return self.k_steps

    def _body(self, entry: _Entry, ctx: _CaptureCtx):
        from .step_capture import _rebuild
        d = entry.disc
        outs = []
        for k in range(self.k_steps):
            for o, col in zip(d.opts, entry.cols):
                lr = o._live[("lr", str(_param_device(o)))][1]
                lr.copy_(entry.lr_stacks[id(o)][k])
                ctx.lr_host[id(o)] = col[k]
            args, kwargs = _rebuild(entry.rebuild,
                                    [t[k] for t in entry.static_in])
            outs.append(self._fn(*args, **kwargs))
        return _stack_outputs(outs)

    def _warm_up(self, entry: _Entry):
        out = super()._warm_up(entry)
        for o in entry.disc.opts:
            o._stale_live("lr")
        return out

    def _capture(self, entry: _Entry) -> None:
        self._fill_stacks(entry)    # the warm-up moved the host schedule
        super()._capture(entry)

    def _attempt_capture(self, key, dyn, rebuild):
        out = super()._attempt_capture(key, dyn, rebuild)
        multi_counters["blocks"] += 1
        return out
