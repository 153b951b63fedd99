"""The port's LR schedulers (``paddle_tpu_torch.optimizer.lr``) against the
JAX package's (``paddle_tpu.optimizer.lr``).

Both compute their values in Python float math with the same expressions,
so every comparison here is exact (``==``), tolerance 0: the sequence of
``last_lr`` over 40 ``step()`` calls for each of the twelve schedulers
(two settings of some), ``step(epoch=)`` jumps, ``ReduceOnPlateau`` in
min and max modes with patience and cooldown (its metric a tensor in the
port, a float in the reference), ``LinearWarmup`` over a wrapped
scheduler, and a ``state_dict`` round trip in the middle of each
sequence. The port's ``LinearWarmup.state_dict`` adds the wrapped
scheduler's state; a reference state without it loads as well.
"""

import math

import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 40

# name -> a function of the lr module that builds the scheduler
SCHEDULERS = {
    "step": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.5),
    "multistep": lambda m: m.MultiStepDecay(0.5, [12, 5, 30], gamma=0.3),
    "exponential": lambda m: m.ExponentialDecay(0.5, gamma=0.93),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, gamma=0.07),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, 15, end_lr=0.01,
                                              power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.5, 15, end_lr=0.01,
                                                    power=1.5, cycle=True),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, T_max=13, eta_min=0.02),
    "warmup_float": lambda m: m.LinearWarmup(0.5, 6, 0.0, 0.5),
    "warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-4, T_max=10), warmup_steps=4,
        start_lr=0.0, end_lr=1e-4),
    "noam": lambda m: m.NoamDecay(64, 8, learning_rate=2.0),
    "lambda": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e
                                      + math.sin(e) / 50),
    "piecewise": lambda m: m.PiecewiseDecay([4, 9, 20],
                                            [0.5, 0.3, 0.1, 0.05]),
    "plateau": lambda m: m.ReduceOnPlateau(0.5, factor=0.5, patience=2,
                                           cooldown=2),
}


def _seq(sched, steps=STEPS):
    out = [sched.last_lr]
    for _ in range(steps):
        sched.step()
        out.append(sched.last_lr)
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_sequence_equals_reference(name):
    make = SCHEDULERS[name]
    t, j = make(tlr), make(jlr)
    assert t() == j() and t.last_epoch == j.last_epoch == 0
    assert _seq(t) == _seq(j)


def test_every_reference_scheduler_is_ported():
    want = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
            and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert want == set(tlr.__all__)
    assert len(want) == 13       # the base and its twelve schedulers


@pytest.mark.parametrize("name", ["step", "cosine", "polynomial_cycle",
                                  "noam", "piecewise", "warmup_float"])
def test_step_with_epoch_jumps_as_reference(name):
    t, j = SCHEDULERS[name](tlr), SCHEDULERS[name](jlr)
    for epoch in (3, 17, 5, 31, 0, 44):
        t.step(epoch=epoch)
        j.step(epoch=epoch)
        assert (t.last_epoch, t.last_lr) == (j.last_epoch, j.last_lr)
        t.step()
        j.step()
        assert t.last_lr == j.last_lr


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_on_plateau_modes_and_cooldown(mode):
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=0.01,
              cooldown=3, min_lr=0.01)
    t, j = tlr.ReduceOnPlateau(0.8, **kw), jlr.ReduceOnPlateau(0.8, **kw)
    sign = 1.0 if mode == "min" else -1.0
    # improves, stalls (two reductions with a cooldown between), improves
    metrics = [5.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0,
               3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]
    lrs = []
    for m in metrics:
        t.step(torch.tensor(sign * m))          # a tensor metric
        j.step(sign * m)
        assert t.last_lr == j.last_lr
        lrs.append(t.last_lr)
    assert min(lrs) < 0.8 / 2                   # it did reduce, twice
    t.step()                                    # no metric: lr held
    j.step()
    assert t.last_lr == j.last_lr and t.last_epoch == j.last_epoch


@pytest.mark.parametrize("name", sorted(set(SCHEDULERS) - {"plateau"}))
def test_state_dict_round_trip_mid_sequence(name):
    make = SCHEDULERS[name]
    a = make(tlr)
    for _ in range(17):
        a.step()
    b = make(tlr)
    b.set_state_dict(a.state_dict())
    assert _seq(a, 23) == _seq(b, 23)


def test_linear_warmup_takes_the_reference_state():
    """The reference's state (no wrapped scheduler's) loads; within the
    warm-up the wrapped scheduler has not moved, so the sequences go on
    equal."""
    make = SCHEDULERS["warmup_cosine"]
    j = make(jlr)
    for _ in range(2):
        j.step()
    t = make(tlr)
    t.set_state_dict(j.state_dict())
    assert _seq(t, 20) == _seq(j, 20)
