"""Learning-rate schedulers.

Counterpart of ``paddle_tpu/optimizer/lr.py`` (:17-226): the
``LRScheduler`` base (``step``, ``state_dict``, ``set_state_dict``; built
with ``last_epoch = -1`` and one ``step()``, so a new scheduler stands at
epoch 0) and its twelve schedulers. The values are Python float math, the
same expressions in the same order as the reference's, so both packages
give equal sequences.

An optimizer reads ``scheduler()`` once per step (``Optimizer.get_lr``);
the caller advances the scheduler with ``step()``, as in Paddle.

``_PROBE`` (the reference's :10-14): while whole-step capture
(``jit/step_capture.py``) runs its discovery step, each ``step()``
reports itself, so replays of the captured graph re-apply the same
host-side advance; a ``step()`` given an epoch or a metric marks the
step as one the capture cannot replay.

One addition: ``LinearWarmup.state_dict`` also holds the wrapped
scheduler's state (``"lr_after"``), so a resume past the warm-up goes on
from where the wrapped schedule stood; ``set_state_dict`` takes a state
without it (the reference's) as well.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

# the discovery sink of jit/step_capture.py while it probes a step
_PROBE = None


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = self.base_lr
        self.verbose = verbose
        self.step()  # initialize to epoch 0

    def __call__(self) -> float:
        return self.last_lr

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None):
        if _PROBE is not None:
            _PROBE.saw_scheduler_step(self, epoch)
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, sd):
        self.last_epoch = sd["last_epoch"]
        self.last_lr = sd["last_lr"]


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones: List[int], gamma=0.1,
                 last_epoch=-1, verbose=False):
        self.milestones, self.gamma = sorted(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * self.gamma ** n


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps, self.end_lr = decay_steps, end_lr
        self.power, self.cycle = power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        if self.cycle:
            div = max(1.0, math.ceil(t / self.decay_steps))
            steps = self.decay_steps * div
        else:
            steps = self.decay_steps
            t = min(t, steps)
        return (self.base_lr - self.end_lr) * (1 - t / steps) ** self.power \
            + self.end_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class LinearWarmup(LRScheduler):
    """Warm up from ``start_lr`` to ``end_lr`` over ``warmup_steps``, then
    follow ``learning_rate`` (a float or a scheduler, which is stepped
    from then on)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr
        super().__init__(end_lr if not isinstance(learning_rate, LRScheduler)
                         else learning_rate.base_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * \
                self.last_epoch / max(1, self.warmup_steps)
        if isinstance(self.lr_after, LRScheduler):
            return self.lr_after()
        return float(self.lr_after)

    def step(self, epoch=None):
        if self.last_epoch >= self.warmup_steps and \
                isinstance(self.lr_after, LRScheduler):
            self.lr_after.step()
        super().step(epoch)

    def state_dict(self):
        sd = super().state_dict()
        if isinstance(self.lr_after, LRScheduler):
            sd["lr_after"] = self.lr_after.state_dict()
        return sd

    def set_state_dict(self, sd):
        super().set_state_dict(sd)
        if "lr_after" in sd and isinstance(self.lr_after, LRScheduler):
            self.lr_after.set_state_dict(sd["lr_after"])


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(1, self.last_epoch)
        return self.base_lr * self.d_model ** -0.5 * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: List[int], values: List[float],
                 last_epoch=-1, verbose=False):
        self.boundaries, self.values = boundaries, values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class ReduceOnPlateau(LRScheduler):
    """Scale the lr by ``factor`` once the metric (a number or a
    one-element tensor) has not improved for more than ``patience``
    steps, then wait ``cooldown`` steps before counting again."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr = cooldown, min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._current = float(learning_rate)
        super().__init__(learning_rate, -1, verbose)

    def get_lr(self):
        return self._current

    def step(self, metrics=None, epoch=None):
        if _PROBE is not None:
            _PROBE.saw_scheduler_step(
                self, metrics if metrics is not None else epoch)
        self.last_epoch += 1
        if metrics is None:
            self.last_lr = self._current
            return
        m = float(metrics.item() if hasattr(metrics, "item") else metrics)
        better = (self.best is None or
                  (self.mode == "min"
                   and m < self.best - abs(self.best) * self.threshold) or
                  (self.mode == "max"
                   and m > self.best + abs(self.best) * self.threshold))
        if better:
            self.best = m
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self._current = max(self._current * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        self.last_lr = self._current


__all__ = ["CosineAnnealingDecay", "ExponentialDecay", "InverseTimeDecay",
           "LRScheduler", "LambdaDecay", "LinearWarmup", "MultiStepDecay",
           "NaturalExpDecay", "NoamDecay", "PiecewiseDecay",
           "PolynomialDecay", "ReduceOnPlateau", "StepDecay"]
