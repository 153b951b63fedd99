"""Optimizers: SGD, Momentum, Adam, AdamW, Lamb, Adamax, Adadelta, ASGD,
Rprop, Adagrad and RMSProp.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: ``Optimizer``
(:161) with ``step``, ``clear_grad`` (alias ``clear_gradients``),
``minimize``, ``get_lr``/``set_lr`` (a float or an ``LRScheduler`` of
``optimizer/lr.py``; ``set_lr`` raises under a scheduler), ``state_dict``/
``set_state_dict`` (:613-634) and ``multi_precision`` float32 masters for
bf16 params (:419-429); ``SGD``, ``Momentum``, ``Adam``, ``AdamW`` and
``Lamb`` (:865-995); ``Adamax``, ``Adadelta``, ``ASGD``, ``Rprop``,
``Adagrad`` and ``RMSProp`` (:998-1186, per-parameter route only: no fused
kernel computes their rules); the fused route's frozen
``FUSED_OPT_FALLBACK_REASONS`` (:69), ``fused_counters`` and
``_fused_kind_cfg`` (:91, exact type match); and the anomaly sentinel
(``FLAGS_anomaly_sentinel``, :450-471).

Two routes, chosen per step and counted:

- **fused** (``FLAGS_fused_optimizer``, the default): one launch of the
  fused kernel per bucket (``ops/kernels/fused_optimizer.py``; for Lamb
  two, with each parameter's two norms reduced in torch between them). A
  deferred GradScaler unscale, a global-norm clip and the sentinel's
  ``found`` fold into the kernel as scalars, so the grads are never
  rewritten.
- **per-param**: the rule applied parameter by parameter in torch ops,
  after the clip has made new grads. Taken when the flag is off or a
  frozen reason disqualifies the step; never as an escape from a failed
  kernel (a kernel failure raises).

Both apply :func:`ops.kernels.fused_optimizer.rule` (Lamb:
``lamb_moments``, ``lamb_trust_ratio``, ``lamb_apply``), the one
implementation of the rule math, so at float32 the routes agree bit for
bit. Every scalar (lr, step, weight decay, bias corrections, clip
coefficient, sentinel flag) is a device tensor: a step syncs with the
host only once, after the update is queued, when the sentinel is on.
The learning rate and the step count are one persistent float32 scalar
each per device, refreshed in place (``fill_``) when the host value
changes (the reference's "one transfer per lr change",
``paddle_tpu/jit/api.py:447-450``), so a scheduled run makes no tensor
per step and the kernels always read the same scalars.

Memory: the masters and the moments of the parameters that share a
compute dtype live in one flat buffer each, allocated at the first step,
with per-parameter views into them; both routes update those views in
place. Nothing else is copied: an AdamW step over bf16 params holds
param 2 + grad 2 + master 4 + m 4 + v 4 = 16 bytes per parameter. Lamb
holds its ``tr_div`` as well: on the fused route one scratch buffer per
bucket kept with the plan, 4 more bytes per parameter over float32
masters.

``parameters`` may be ``(name, param)`` pairs (``Module.named_parameters()``):
the names are what AdamW's ``apply_decay_param_fun`` is given (Paddle
gives ``param.name``); a plain list gives it ``param_{i}``.

``state_dict`` returns copies; ``set_state_dict`` makes the state it
lacks and copies into the flat buffers' views (the fused plans hold
them), so a resume continues bit for bit on either route.

Whole-step capture (``jit/step_capture.py``, the reference's ``_PROBE`` /
``_CAPTURE``, :30): while it probes a step, ``_PROBE`` sees each
optimizer at the top of ``step()``; while it captures or replays one,
``_CAPTURE`` hands ``step()`` the learning rate (refreshed on the host's
stream before each replay, outside the graph) and the step scalar (a
device counter the graph advances itself, by ``1 - found`` when an
update is guarded), and the sentinel's host sync is left out: a skipped
update stays on the device and ``consume_anomaly()`` reconciles the host
count from the cumulative-skip channel. ``clear_grad()`` under capture
zeroes in place the grads a captured step keeps in storage made before
it (an accumulation window's); other grads it frees, as eagerly.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .. import flags as _flags
from ..nn.clip import ClipGradBase, ClipGradByGlobalNorm, sum_of_squares
from ..ops.kernels import fused_optimizer as fok
from .lr import LRScheduler

# Frozen fallback-reason taxonomy of the fused route: every reason that
# reaches _fused_fallback() is one of these (it raises on any other).
# The port has no sharding yet, so the sharding reason never occurs.
FUSED_OPT_FALLBACK_REASONS = frozenset({
    "FLAGS_fused_optimizer disabled",
    "optimizer rule has no fused kernel",
    "ZeRO/GSPMD sharding active on params or optimizer state",
    "tensor hook attached to a parameter",
    "unsupported param/grad dtype layout",
})

# step-capture hooks (jit/step_capture.py): the discovery sink while a
# step is probed, the capture context while one is captured or replayed
_PROBE = None
_CAPTURE = None

# `buckets`: the bucket count of the most recent fused plan;
# `updates`/`fallbacks`: steps that took the fused / per-param route
fused_counters = {"buckets": 0, "updates": 0, "fallbacks": 0}

_LOW = (torch.bfloat16, torch.float16)


def _fused_kind_cfg(opt):
    """(kind, static hyperparameters) of the optimizers with a fused rule,
    by EXACT type, so a subclass with its own ``_update`` never reaches
    the stock kernel."""
    t = type(opt)
    if t is SGD:
        return "sgd", {}
    if t is Momentum:
        return "momentum", {"momentum": float(opt._momentum),
                            "nesterov": bool(opt._nesterov)}
    if t is Adam or t is AdamW:
        return "adam", {"b1": float(opt._beta1), "b2": float(opt._beta2),
                        "eps": float(opt._eps),
                        "decoupled": bool(opt._decoupled())}
    if t is Lamb:
        return "lamb", opt._cfg()
    return None, None


def inv_scale(scale: torch.Tensor) -> torch.Tensor:
    """The GradScaler's reciprocal, float32 on the device."""
    return torch.reciprocal(scale.float())


def conditioned(grads: Iterable[torch.Tensor], inv=None, coeff=None):
    """The grads as the per-param route sees them, one at a time
    (:func:`ops.kernels.fused_optimizer.condition_grad`). A generator, so
    reductions over it hold one temporary."""
    return (fok.condition_grad(g, inv, coeff) for g in grads)


def sentinel_reduce(grads: Iterable[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(found, global_norm)`` as float32 device scalars: found is 1 when
    any grad element is not finite (a flag of its own, exact where the
    float32 square sum would overflow). Never a host sync."""
    finite = []

    def tap(gs):
        for g in gs:
            finite.append(torch.isfinite(g).all())
            yield g
    sq = sum_of_squares(tap(grads))
    found = torch.logical_not(torch.stack(finite).all()).float()
    return found, torch.sqrt(sq)


def _merge_found(found, gnorm, ext):
    """The sentinel's ``(found, gnorm)`` and a GradScaler's (``ext``,
    handed over under capture) as one guard: found if either found."""
    if ext is None:
        return found, gnorm
    if found is None:
        return ext
    return torch.maximum(found, ext[0]), gnorm


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 multi_precision: bool = True, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (a list of "
                             "tensors)")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        params = list(parameters)
        # (name, param) pairs, as Module.named_parameters() gives them:
        # the names reach apply_decay_param_fun (Paddle's param.name)
        named = bool(params) and all(isinstance(x, tuple) for x in params)
        self._param_names = [n for n, _ in params] if named \
            else [None] * len(params)
        self._parameter_list = [p for _, p in params] if named else params
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._weight_decay = 0.0 if weight_decay is None else float(
            getattr(weight_decay, "coeff", weight_decay))
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._apply_decay_param_fun = None   # set by AdamW
        n = len(self._parameter_list)
        self._states: List[Optional[Dict[str, torch.Tensor]]] = [None] * n
        self._masters: List[Optional[torch.Tensor]] = [None] * n
        self._step_count = 0
        # [found, global_norm, cumulative_skips] of the last guarded step
        self._anomaly: Optional[torch.Tensor] = None
        self._reconciled_skips = 0
        # the GradScaler's deferred scale, applied inside the fused kernel
        self._pending_scale: Optional[torch.Tensor] = None
        # the GradScaler's (found, gnorm) under capture: the update is
        # masked on the device instead of skipped on the host
        self._pending_found: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None
        self._fused_plans: Dict = {}
        self._fused_last_reason: Optional[str] = None
        self._scalars: Dict = {}
        self._live: Dict = {}

    # -- lr and weight decay --------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value: float) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("optimizer uses an LRScheduler; call "
                               "scheduler APIs")
        self._lr = float(value)

    def _param_weight_decay(self, i: int) -> float:
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(self._param_names[i] or f"param_{i}"):
            return 0.0
        return self._weight_decay

    def _scalar(self, value: float, device) -> torch.Tensor:
        """A float32 device scalar of ``value``, made once (by a fill on
        the device, not a host copy)."""
        key = (float(value), str(device))
        t = self._scalars.get(key)
        if t is None:
            t = torch.full((), float(value), dtype=torch.float32,
                           device=device)
            self._scalars[key] = t
        return t

    def _live_scalar(self, key: str, value: float, device) -> torch.Tensor:
        """The persistent float32 device scalar ``key`` (the lr, the step
        count): one tensor per device, refreshed in place only when the
        host value changes."""
        slot = self._live.get((key, str(device)))
        value = float(value)
        if slot is None:
            slot = [value, torch.full((), value, dtype=torch.float32,
                                      device=device)]
            self._live[(key, str(device))] = slot
        elif slot[0] != value:
            self._refresh(slot[1], value)
            slot[0] = value
        return slot[1]

    @staticmethod
    def _refresh(t: torch.Tensor, value: float) -> None:
        t.fill_(value)   # a kernel argument: no host copy, no sync

    def _stale_live(self, key: str) -> None:
        """Forget the host value behind the live scalar ``key`` on every
        device (a graph wrote the tensor), so the next read refreshes."""
        for (k, _), slot in self._live.items():
            if k == key:
                slot[0] = math.nan

    def _dev_step(self, device) -> torch.Tensor:
        """The captured step's device step counter: applied updates so
        far, float32. Refilled from the host count (outside any graph)
        when that count moved other than by the graph's own advance: a
        ``set_state_dict``, or ``consume_anomaly`` reconciling skips."""
        return self._live_scalar("dev_step", self._step_count, device)

    # -- the rule (override) --------------------------------------------------
    _STATE_KEYS: Tuple[str, ...] = ()   # the rule's state slots

    def _step_scalars(self, step: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-step device scalars the rule reads besides lr and wd."""
        return {}

    def _update(self, p, g, state, lr, wd, sc):
        """One parameter's rule: ``(new_p, new_state)``; ``g`` is already
        cast to ``p.dtype``."""
        raise NotImplementedError

    def _slot_specs(self) -> Dict[str, Tuple[float, Tuple[int, ...]]]:
        """Each state slot's ``(initial value, leading dims)``: a slot
        holds ``leading dims + param shape`` elements."""
        return {k: (0.0, ()) for k in self._STATE_KEYS}

    def _state_targets(self, state, sc) -> Dict[str, torch.Tensor]:
        """The current value of each slot of ``_update``'s new state (what
        a skipped step keeps; ASGD's is one row of its gradient ring)."""
        return state

    def _store_state(self, state, sc, new_s) -> None:
        """Write ``_update``'s new state into the slots, in place."""
        for k, v in new_s.items():
            state[k].copy_(v)

    # -- state ----------------------------------------------------------------
    def _create_state(self, idxs: List[int]) -> None:
        """Masters and state of the parameters that have none yet: one
        flat buffer per (device, compute dtype) and slot, per-parameter
        views into it, filled with the slot's initial value. Each view
        starts on a ``fok.STATE_ALIGN``-byte boundary, so the fused
        kernel reads and writes every row of a bucket in whole vector
        accesses."""
        todo = [i for i in idxs if self._states[i] is None]
        if not todo:
            return
        params = self._parameter_list
        slots = self._slot_specs()
        groups: Dict[Tuple, List[int]] = {}
        for i in todo:
            p = params[i]
            cdt = torch.float32 if self._multi_precision and p.dtype in _LOW \
                else p.dtype
            groups.setdefault((p.device, cdt), []).append(i)

        def views(ids, dtype, device, fill=0.0, lead=()):
            n_lead = math.prod(lead)
            step = fok.STATE_ALIGN // dtype.itemsize
            sizes = [n_lead * params[i].numel() for i in ids]
            offs = list(itertools.accumulate(
                (-(-n // step) * step for n in sizes), initial=0))
            flat = torch.full((offs[-1],), fill, dtype=dtype, device=device)
            return [flat[o:o + n].view(*lead, *params[i].shape)
                    for i, o, n in zip(ids, offs, sizes)]

        for (dev, cdt), ids in groups.items():
            masters = [i for i in ids if params[i].dtype != cdt]
            for i, v in zip(masters, views(masters, cdt, dev)):
                v.copy_(params[i].detach())
                self._masters[i] = v
            per_key = {k: views(ids, cdt, dev, fill, lead)
                       for k, (fill, lead) in slots.items()}
            for j, i in enumerate(ids):
                self._states[i] = {k: per_key[k][j] for k in slots}

    # -- fused route ----------------------------------------------------------
    def _fused_fallback(self, reason: str) -> None:
        if reason not in FUSED_OPT_FALLBACK_REASONS:
            raise ValueError(f"unregistered fused-optimizer fallback reason "
                             f"{reason!r}: add it to "
                             f"FUSED_OPT_FALLBACK_REASONS")
        fused_counters["fallbacks"] += 1
        self._fused_last_reason = reason

    def _fused_specs(self, idxs):
        """Per-param (shape, compute dtype, grad dtype, write-back dtype,
        wd) layout keys, or None when a dtype has no kernel."""
        specs = []
        for i in idxs:
            p = self._parameter_list[i]
            master = self._multi_precision and p.dtype in _LOW
            cdt = torch.float32 if master else p.dtype
            names = [str(d).removeprefix("torch.")
                     for d in (cdt, p.grad.dtype)]
            if any(n not in fok.DTYPES for n in names) or \
                    (master and p.dtype != torch.bfloat16):
                return None
            specs.append((tuple(p.shape), names[0], names[1],
                          "bfloat16" if master else None,
                          self._param_weight_decay(i)))
        return tuple(specs)

    def _fused_route(self, idxs, record: bool = True):
        """The bucket plan for this step, or None with the frozen reason
        counted (when ``record``)."""
        kind, cfg = _fused_kind_cfg(self)
        params = self._parameter_list
        reason = specs = None
        if not _flags.get_flag("fused_optimizer"):
            reason = "FLAGS_fused_optimizer disabled"
        elif kind not in fok.KINDS:
            reason = "optimizer rule has no fused kernel"
        elif any(getattr(params[i], "_backward_hooks", None)
                 or getattr(params[i], "_post_accumulate_grad_hooks", None)
                 for i in idxs):
            reason = "tensor hook attached to a parameter"
        else:
            specs = self._fused_specs(idxs)
            if specs is None:
                reason = "unsupported param/grad dtype layout"
        if reason is not None:
            if record:
                self._fused_fallback(reason)
            return None
        key = (kind, tuple(sorted(cfg.items())), specs)
        plan = self._fused_plans.get(key)
        if plan is None:
            plan = fok.plan_buckets(kind, cfg, specs)
            self._fused_plans[key] = plan
        return plan

    def _fused_defer_scale(self) -> bool:
        """GradScaler.unscale_ asks: will step() take the fused route, so
        the unscale can ride the kernel? A clip other than the global-norm
        one needs unscaled grads first. Counts no fallback."""
        if not _flags.get_flag("fused_optimizer") or not (
                self._grad_clip is None
                or isinstance(self._grad_clip, ClipGradByGlobalNorm)):
            return False
        idxs = self._grad_idxs()
        return bool(idxs) and self._fused_route(idxs, record=False) is not None

    # -- step -----------------------------------------------------------------
    def _grad_idxs(self) -> List[int]:
        return [i for i, p in enumerate(self._parameter_list)
                if p.grad is not None and p.requires_grad]

    @torch.no_grad()
    def step(self) -> None:
        if _PROBE is not None:
            _PROBE.saw_optimizer(self)
        cap = _CAPTURE
        idxs = self._grad_idxs()
        if not idxs:
            return
        params = [self._parameter_list[i] for i in idxs]
        grads = [p.grad for p in params]
        dev = grads[0].device
        scale, self._pending_scale = self._pending_scale, None
        plan = self._fused_route(idxs)
        inv = None if scale is None else inv_scale(scale)
        if plan is None and inv is not None:
            # the route was eligible when the GradScaler deferred its
            # unscale and is not now: unscale here, as the scaler would
            grads, inv = list(conditioned(grads, inv)), None
        fold_clip = plan is not None and isinstance(self._grad_clip,
                                                    ClipGradByGlobalNorm)
        if self._grad_clip is not None and not fold_clip:
            grads = [g for _, g in self._grad_clip(list(zip(params, grads)))]
        self._step_count += 1
        self._create_state(idxs)
        if cap is None:
            lr = self._live_scalar("lr", self.get_lr(), dev)
            step = self._live_scalar("step", self._step_count, dev)
        else:
            lr, step = cap.lr(self, dev), cap.step(self, dev)
        sentinel = bool(_flags.get_flag("anomaly_sentinel"))
        ext, self._pending_found = self._pending_found, None
        targets = [self._masters[i] if self._masters[i] is not None
                   else self._parameter_list[i].detach() for i in idxs]
        states = [self._states[i] for i in idxs]
        found = gnorm = None
        if plan is not None:
            coeff = None
            if fold_clip:   # the clip's own coefficient, not its rewrite
                coeff = self._grad_clip.coeff(conditioned(grads, inv),
                                              params)
            if sentinel:
                found, gnorm = sentinel_reduce(conditioned(grads, inv, coeff))
            found, gnorm = _merge_found(found, gnorm, ext)
            one = self._scalar(1.0, dev)
            lows = [p.detach() if self._masters[i] is not None else None
                    for i, p in zip(idxs, params)]
            fok.fused_apply(
                plan, targets, grads, states, lows, lr, step,
                one if inv is None else inv, one if coeff is None else coeff,
                self._scalar(0.0, dev) if found is None else found,
                [self._scalar(b.wd, dev) for b in plan.buckets])
            fused_counters["updates"] += 1
            fused_counters["buckets"] = len(plan.buckets)
        else:
            if sentinel:
                found, gnorm = sentinel_reduce(grads)
            found, gnorm = _merge_found(found, gnorm, ext)
            sc = self._step_scalars(step)
            for i, p, target, g, st in zip(idxs, params, targets, grads,
                                           states):
                g = g.to(target.dtype)
                new_p, new_s = self._update(
                    target, g, st, lr,
                    self._scalar(self._param_weight_decay(i), dev), sc)
                if found is not None:
                    keep = found > 0
                    old = self._state_targets(st, sc)
                    new_p = torch.where(keep, target, new_p)
                    new_s = {k: torch.where(keep, old[k], v)
                             for k, v in new_s.items()}
                target.copy_(new_p)
                self._store_state(st, sc, new_s)
                if self._masters[i] is not None:
                    p.detach().copy_(target.to(p.dtype))
        if found is not None:
            self._stash_anomaly(found, gnorm)
        if cap is not None:
            # no host sync: the device counter advances by the updates
            # applied, consume_anomaly() reconciles the host count
            cap.advance(self, dev, found)
        elif found is not None and bool(found > 0):
            # the one host sync, after the update is queued: keeps the
            # step count at applied updates
            self._step_count -= 1
            self._reconciled_skips += 1

    # -- sentinel -------------------------------------------------------------
    def _stash_anomaly(self, found: torch.Tensor, gnorm: torch.Tensor
                       ) -> None:
        """``[found, global_norm, cumulative_skips]`` of the last guarded
        step, written in place into one persistent tensor, so a captured
        graph keeps adding to the same cumulative channel."""
        a = self._anomaly
        if a is None or a.device != found.device:
            a = self._anomaly = torch.zeros(3, dtype=torch.float32,
                                            device=found.device)
        a.copy_(torch.stack([found.float(), gnorm.float(),
                             a[2] + found.float()]))

    def consume_anomaly(self) -> Optional[Tuple[bool, float]]:
        """Host-read the last guarded step: ``(skipped, grad_norm)``, or
        None when no guarded step ran. Reconciles the step count against
        the device's cumulative-skip count."""
        if self._anomaly is None:
            return None
        a = self._anomaly.tolist()
        cum = int(round(a[2]))
        delta = cum - self._reconciled_skips
        if delta > 0:
            self._step_count = max(0, self._step_count - delta)
        self._reconciled_skips = cum
        return a[0] > 0, a[1]

    def clear_grad(self, set_to_zero: bool = False) -> None:
        cap = _CAPTURE
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if cap is not None and cap.clear_grad(p):
                continue   # a captured step's grad storage: zeroed
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None) -> None:
        loss.backward()
        self.step()
        self.clear_grad()

    # -- checkpointing --------------------------------------------------------
    def state_dict(self) -> Dict:
        """``{"step", "states", "masters"}`` (and ``"lr"``, the
        scheduler's state, under a scheduler), per parameter in the
        optimizer's order; the tensors are copies."""
        def cp(t):
            return None if t is None else t.detach().clone()

        out = {"step": self._step_count,
               "states": [None if s is None else {k: cp(v)
                                                  for k, v in s.items()}
                          for s in self._states],
               "masters": [cp(m) for m in self._masters]}
        if isinstance(self._lr, LRScheduler):
            out["lr"] = self._lr.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, sd: Dict) -> None:
        """Load a :meth:`state_dict` (tensors or numpy arrays): the state
        of each listed parameter is made where missing, then copied into
        its views (never rebound: the fused plans hold those views)."""
        n = len(self._parameter_list)
        states, masters = sd.get("states"), sd.get("masters")
        for key, lst in (("states", states), ("masters", masters)):
            if lst is not None and len(lst) != n:
                raise ValueError(f"state_dict {key!r} lists {len(lst)} "
                                 f"parameters, the optimizer has {n}")
        states = states if states is not None else [None] * n
        masters = masters if masters is not None else [None] * n
        have = [i for i in range(n)
                if states[i] is not None or masters[i] is not None]
        self._create_state(have)
        for i in have:
            own = dict(self._states[i])
            if masters[i] is not None:
                if self._masters[i] is None:
                    raise ValueError(f"parameter {i} keeps no float32 master "
                                     f"here, the state_dict has one")
                own["master"] = self._masters[i]
            src = dict(states[i] or {})
            if masters[i] is not None:
                src["master"] = masters[i]
            if states[i] is not None and \
                    set(states[i]) != set(self._states[i]):
                raise KeyError(f"parameter {i}: state slots "
                               f"{sorted(states[i])}, expected "
                               f"{sorted(self._states[i])}")
            for k, v in src.items():
                v = torch.as_tensor(v)
                if tuple(v.shape) != tuple(own[k].shape):
                    raise ValueError(f"parameter {i} slot {k!r}: shape "
                                     f"{tuple(v.shape)}, expected "
                                     f"{tuple(own[k].shape)}")
                own[k].copy_(v)
        self._step_count = int(sd.get("step", 0))
        if "lr" in sd and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(sd["lr"])


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _update(self, p, g, state, lr, wd, sc):
        return fok.rule("sgd", {}, p, g, state, lr, wd)


class Momentum(Optimizer):
    _STATE_KEYS = fok.STATE_KEYS["momentum"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, p, g, state, lr, wd, sc):
        return fok.rule("momentum", {"momentum": float(self._momentum),
                                     "nesterov": bool(self._nesterov)},
                        p, g, state, lr, wd)


class Adam(Optimizer):
    _STATE_KEYS = fok.STATE_KEYS["adam"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _decoupled(self) -> bool:
        return False

    def _step_scalars(self, step):
        bc1, bc2 = fok.bias_inv(self._beta1, self._beta2, step)
        return {"inv_bc1": bc1, "inv_bc2": bc2}

    def _update(self, p, g, state, lr, wd, sc):
        cfg = {"b1": float(self._beta1), "b2": float(self._beta2),
               "eps": float(self._eps), "decoupled": self._decoupled()}
        return fok.rule("adam", cfg, p, g, state, lr, wd, sc["inv_bc1"],
                        sc["inv_bc2"])


class AdamW(Adam):
    """Decoupled weight decay."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None, lr_ratio=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun
        # stored and read nowhere, as in the reference (:944)
        self._lr_ratio = lr_ratio

    def _decoupled(self) -> bool:
        return True


class Lamb(Optimizer):
    """Layer-wise adaptive moments (the reference's ``Lamb``, :950):
    Adam's bias-corrected moments give ``tr_div = m̂/(sqrt(v̂)+eps) +
    wd·p``, and each parameter moves by ``lr·r·tr_div`` with its trust
    ratio ``r = ‖p‖/‖tr_div‖`` (1 when either norm is 0). A parameter for
    which ``exclude_from_weight_decay_fn(param)`` (given the parameter, as
    the reference does) is true takes no weight decay, and so lands in a
    fused bucket of its own."""

    _STATE_KEYS = fok.STATE_KEYS["lamb"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _cfg(self) -> Dict[str, float]:
        return {"b1": float(self._beta1), "b2": float(self._beta2),
                "eps": float(self._eps)}

    def _param_weight_decay(self, i: int) -> float:
        if self._exclude_fn is not None and \
                self._exclude_fn(self._parameter_list[i]):
            return 0.0
        return self._weight_decay

    def _step_scalars(self, step):
        bc1, bc2 = fok.bias_inv(self._beta1, self._beta2, step)
        return {"inv_bc1": bc1, "inv_bc2": bc2}

    def _update(self, p, g, state, lr, wd, sc):
        m, v, tr_div = fok.lamb_moments(self._cfg(), p, g, state, wd,
                                        sc["inv_bc1"], sc["inv_bc2"])
        r = fok.lamb_trust_ratio(p, tr_div)
        return fok.lamb_apply(p, tr_div, r, lr), {"m": m, "v": v}


# -- the per-parameter rules (:998-1186) --------------------------------------
# Each is the reference's ``_update`` in torch ops, one op per rounding in
# the reference's order; a divisor that varies is a device scalar, so the
# card divides as the CPU does (a divisor given as a Python number is a
# reciprocal multiply on the card).

class Adamax(Optimizer):
    """Adam with the infinity norm: ``inf = max(|g|, b2·inf + eps)``,
    ``p -= lr/(1 - b1^t) · m / inf``; the weight decay is added to the
    grad."""

    _STATE_KEYS = ("m", "inf")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _step_scalars(self, step):
        bc1, _ = fok.bias_inv(self._beta1, self._beta2, step)
        return {"inv_bc1": bc1}

    def _update(self, p, g, state, lr, wd, sc):
        b1, b2, eps = self._beta1, self._beta2, self._eps
        lr = lr.to(p.dtype)
        g = g + wd.to(p.dtype) * p
        m = b1 * state["m"] + (1 - b1) * g
        inf = torch.maximum(torch.abs(g), b2 * state["inf"] + eps)
        lr_t = lr * sc["inv_bc1"].to(lr.dtype)
        return p - lr_t * m / inf, {"m": m, "inf": inf}


class Adadelta(Optimizer):
    """``E[g²] = ρE[g²] + (1-ρ)g²``, ``upd = -sqrt(E[dx²]+eps) /
    sqrt(E[g²]+eps) · g``, ``E[dx²] = ρE[dx²] + (1-ρ)upd²``, ``p +=
    lr·upd``."""

    _STATE_KEYS = ("g2", "dx2")

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._eps = rho, epsilon

    def _update(self, p, g, state, lr, wd, sc):
        rho, eps = self._rho, self._eps
        g = g + wd.to(p.dtype) * p
        g2 = rho * state["g2"] + (1 - rho) * (g * g)
        upd = -torch.sqrt(state["dx2"] + eps) / torch.sqrt(g2 + eps) * g
        dx2 = rho * state["dx2"] + (1 - rho) * (upd * upd)
        return p + lr.to(p.dtype) * upd, {"g2": g2, "dx2": dx2}


class ASGD(Optimizer):
    """Averaged SGD over the last ``batch_num`` grads: slot ``(t-1) % n``
    of the ring ``ys`` (``[n, *shape]``) is swapped out of the running sum
    ``d``, and ``p -= lr·(d / min(t, n) + wd·p)``. ``t`` is the device
    step scalar (applied updates, this one included), so the slot is
    picked on the device (``index_select`` / ``index_copy_``) and a
    captured step replays with the live count: a step the sentinel or the
    GradScaler skips leaves the ring, the sum and the count as they were,
    so the next step writes the same slot, as in the reference."""

    _STATE_KEYS = ("d", "ys")

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        if batch_num < 1:
            raise ValueError("batch_num must be >= 1")
        self._n = int(batch_num)

    def _slot_specs(self):
        return {"d": (0.0, ()), "ys": (0.0, (self._n,))}

    def _step_scalars(self, step):
        idx = torch.remainder(step - 1.0, float(self._n)).long().reshape(1)
        return {"idx": idx, "denom": torch.clamp(step, max=float(self._n))}

    def _state_targets(self, state, sc):
        return {"d": state["d"],
                "ys": state["ys"].index_select(0, sc["idx"])[0]}

    def _store_state(self, state, sc, new_s):
        state["d"].copy_(new_s["d"])
        state["ys"].index_copy_(0, sc["idx"], new_s["ys"].unsqueeze(0))

    def _update(self, p, g, state, lr, wd, sc):
        y_old = state["ys"].index_select(0, sc["idx"])[0]
        d = state["d"] - y_old + g
        upd = d / sc["denom"].to(p.dtype) + wd.to(p.dtype) * p
        return p - lr.to(p.dtype) * upd, {"d": d, "ys": g}


class Rprop(Optimizer):
    """Resilient backprop: a per-element step size that grows by
    ``etas[1]`` (capped at ``learning_rate_range[1]``) while the grad
    keeps its sign, shrinks by ``etas[0]`` (floored at
    ``learning_rate_range[0]``) and skips the update when it flips. The
    learning rate seeds the step sizes, so a scheduler raises
    ``TypeError``; there is no weight decay."""

    _STATE_KEYS = ("prev", "lrs")

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=True, name=None):
        if isinstance(learning_rate, LRScheduler):
            raise TypeError(
                "Rprop keeps per-element step sizes seeded from a float "
                "learning_rate; LR schedulers do not apply (full-batch "
                "only)")
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr0 = float(learning_rate)
        self._lr_min, self._lr_max = (float(x) for x in learning_rate_range)
        self._eta_minus, self._eta_plus = (float(x) for x in etas)

    def _slot_specs(self):
        return {"prev": (0.0, ()), "lrs": (self._lr0, ())}

    def _update(self, p, g, state, lr, wd, sc):
        sign = g * state["prev"]
        lrs = torch.where(
            sign > 0, torch.clamp(state["lrs"] * self._eta_plus,
                                  max=self._lr_max),
            torch.where(sign < 0, torch.clamp(state["lrs"] * self._eta_minus,
                                              min=self._lr_min),
                        state["lrs"]))
        step_w = torch.where(sign < 0, torch.zeros_like(p),
                             torch.sign(g) * lrs)
        prev = torch.where(sign < 0, torch.zeros_like(g), g)
        return p - step_w, {"prev": prev, "lrs": lrs}


class Adagrad(Optimizer):
    """``acc += g²``, ``p -= lr·g / (sqrt(acc) + eps)``; ``acc`` starts at
    ``initial_accumulator_value``."""

    _STATE_KEYS = ("acc",)

    def __init__(self, learning_rate=0.001, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._eps = epsilon
        self._init_acc = float(initial_accumulator_value)

    def _slot_specs(self):
        return {"acc": (self._init_acc, ())}

    def _update(self, p, g, state, lr, wd, sc):
        g = g + wd.to(p.dtype) * p
        acc = state["acc"] + g * g
        return p - lr.to(p.dtype) * g / (torch.sqrt(acc) + self._eps), \
            {"acc": acc}


class RMSProp(Optimizer):
    """``ms = ρ·ms + (1-ρ)g²``; centered, ``mg = ρ·mg + (1-ρ)g`` and the
    denominator ``sqrt(ms - mg² + eps)``, else ``sqrt(ms + eps)``; ``mom =
    momentum·mom + lr·g/denom``, ``p -= mom``. The ``mg`` slot exists only
    when centered."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-06,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered
        self._STATE_KEYS = ("ms", "mom") + (("mg",) if centered else ())

    def _update(self, p, g, state, lr, wd, sc):
        rho = self._rho
        g = g + wd.to(p.dtype) * p
        ms = rho * state["ms"] + (1 - rho) * (g * g)
        if self._centered:
            mg = rho * state["mg"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + self._eps)
            new_state = {"ms": ms, "mg": mg}
        else:
            denom = torch.sqrt(ms + self._eps)
            new_state = {"ms": ms}
        mom = self._momentum * state["mom"] + lr.to(p.dtype) * g / denom
        new_state["mom"] = mom
        return p - mom, new_state
