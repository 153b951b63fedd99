"""Optimizers: SGD, Momentum, Adam and AdamW.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: ``Optimizer``
(:161) with ``step``, ``clear_grad``, ``get_lr``/``set_lr`` (a float
learning rate; schedulers are not ported yet) and ``multi_precision``
float32 masters for bf16 params (:419-429); ``SGD``, ``Momentum``,
``Adam`` and ``AdamW`` (:865-947); the fused route's frozen
``FUSED_OPT_FALLBACK_REASONS`` (:69), ``fused_counters`` and
``_fused_kind_cfg`` (:91, exact type match); and the anomaly sentinel
(``FLAGS_anomaly_sentinel``, :450-471).

Two routes, chosen per step and counted:

- **fused** (``FLAGS_fused_optimizer``, the default): one launch of the
  fused kernel per bucket (``ops/kernels/fused_optimizer.py``). A
  deferred GradScaler unscale, a global-norm clip and the sentinel's
  ``found`` fold into the kernel as scalars, so the grads are never
  rewritten.
- **per-param**: the rule applied parameter by parameter in torch ops,
  after the clip has made new grads. Taken when the flag is off or a
  frozen reason disqualifies the step; never as an escape from a failed
  kernel (a kernel failure raises).

Both apply :func:`ops.kernels.fused_optimizer.rule`, the one
implementation of the rule math, so at float32 the routes agree bit for
bit. Every scalar (lr, step, weight decay, bias corrections, clip
coefficient, sentinel flag) is a device tensor: a step syncs with the
host only once, after the update is queued, when the sentinel is on.

Memory: the masters and the moments of the parameters that share a
compute dtype live in one flat buffer each, allocated at the first step,
with per-parameter views into them; both routes update those views in
place. Nothing else is copied: an AdamW step over bf16 params holds
param 2 + grad 2 + master 4 + m 4 + v 4 = 16 bytes per parameter.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .. import flags as _flags
from ..nn.clip import (ClipGradBase, ClipGradByGlobalNorm, global_norm_coeff,
                       sum_of_squares)
from ..ops.kernels import fused_optimizer as fok

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


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip: Optional[ClipGradBase] = None,
                 multi_precision: bool = True, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (a list of "
                             "tensors)")
        if not isinstance(learning_rate, (int, float)):
            raise TypeError("only a float learning rate is ported; LR "
                            "schedulers (optimizer/lr.py) are ROADMAP A5")
        self._parameter_list = list(parameters)
        self._lr = float(learning_rate)
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
        self._fused_plans: Dict = {}
        self._fused_last_reason: Optional[str] = None
        self._scalars: Dict = {}

    # -- lr and weight decay --------------------------------------------------
    def get_lr(self) -> float:
        return self._lr

    def set_lr(self, value: float) -> None:
        self._lr = float(value)

    def _param_weight_decay(self, i: int) -> float:
        fn = self._apply_decay_param_fun
        if fn is not None:
            p = self._parameter_list[i]
            if not fn(getattr(p, "name", None) or f"param_{i}"):
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

    # -- the rule (override) --------------------------------------------------
    _STATE_KEYS: Tuple[str, ...] = ()   # the rule's state slots

    def _step_scalars(self, step: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-step device scalars the rule reads besides lr and wd."""
        return {}

    def _update(self, p, g, state, lr, wd, sc):
        """One parameter's rule: ``(new_p, new_state)``; ``g`` is already
        cast to ``p.dtype``."""
        raise NotImplementedError

    # -- state ----------------------------------------------------------------
    def _create_state(self, idxs: List[int]) -> None:
        """Masters and state of the parameters that have none yet: one
        flat buffer per (device, compute dtype) and slot, per-parameter
        views into it."""
        todo = [i for i in idxs if self._states[i] is None]
        if not todo:
            return
        params = self._parameter_list
        keys = self._STATE_KEYS
        groups: Dict[Tuple, List[int]] = {}
        for i in todo:
            p = params[i]
            cdt = torch.float32 if self._multi_precision and p.dtype in _LOW \
                else p.dtype
            groups.setdefault((p.device, cdt), []).append(i)

        def views(flat, ids):
            out, off = [], 0
            for i in ids:
                n = params[i].numel()
                out.append(flat[off:off + n].view(params[i].shape))
                off += n
            return out

        def flat(ids, dtype, device):
            return torch.zeros(sum(params[i].numel() for i in ids),
                               dtype=dtype, device=device)

        for (dev, cdt), ids in groups.items():
            masters = [i for i in ids if params[i].dtype != cdt]
            if masters:
                for i, v in zip(masters, views(flat(masters, cdt, dev),
                                               masters)):
                    v.copy_(params[i].detach())
                    self._masters[i] = v
            per_key = {k: views(flat(ids, cdt, dev), ids) for k in keys}
            for j, i in enumerate(ids):
                self._states[i] = {k: per_key[k][j] for k in keys}

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
        lr = self._scalar(self.get_lr(), dev)
        step = torch.full((), float(self._step_count), dtype=torch.float32,
                          device=dev)
        sentinel = bool(_flags.get_flag("anomaly_sentinel"))
        targets = [self._masters[i] if self._masters[i] is not None
                   else self._parameter_list[i].detach() for i in idxs]
        states = [self._states[i] for i in idxs]
        found = gnorm = None
        if plan is not None:
            coeff = None
            if fold_clip:   # the clip's own coefficient, not its rewrite
                coeff = global_norm_coeff(conditioned(grads, inv),
                                          self._grad_clip.clip_norm)
            if sentinel:
                found, gnorm = sentinel_reduce(conditioned(grads, inv, coeff))
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
            sc = self._step_scalars(step)
            for i, p, target, g, st in zip(idxs, params, targets, grads,
                                           states):
                g = g.to(target.dtype)
                new_p, new_s = self._update(
                    target, g, st, lr,
                    self._scalar(self._param_weight_decay(i), dev), sc)
                if found is not None:
                    keep = found > 0
                    new_p = torch.where(keep, target, new_p)
                    new_s = {k: torch.where(keep, st[k], v)
                             for k, v in new_s.items()}
                target.copy_(new_p)
                for k, v in new_s.items():
                    st[k].copy_(v)
                if self._masters[i] is not None:
                    p.detach().copy_(target.to(p.dtype))
        if found is not None:
            self._stash_anomaly(found, gnorm)
            # the one host sync, after the update is queued: keeps the
            # step count at applied updates
            if bool(found > 0):
                self._step_count -= 1
                self._reconciled_skips += 1

    # -- sentinel -------------------------------------------------------------
    def _stash_anomaly(self, found: torch.Tensor, gnorm: torch.Tensor
                       ) -> None:
        prev = self._anomaly[2] if self._anomaly is not None \
            else torch.zeros((), dtype=torch.float32, device=found.device)
        self._anomaly = torch.stack([found.float(), gnorm.float(),
                                     prev + found.float()])

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
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None


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
        if lr_ratio is not None:
            raise NotImplementedError("AdamW lr_ratio is not ported yet "
                                      "(ROADMAP A5)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self) -> bool:
        return True
