"""The port's per-parameter optimizers (``Adamax``, ``Adadelta``, ``ASGD``,
``Rprop``, ``Adagrad``, ``RMSProp``) and scheduled learning rates against
the JAX package's.

The same parameters and grad stream (numpy, seeded) go through both
packages for 5 steps, with weight decay (Rprop has none) and a
global-norm clip, in float32 and as bf16 parameters with float32 masters.
Held to the reference:

- float32 parameters and every state slot: atol 1e-6, rtol 1e-5. Both
  sides round the same operations in the same order, but XLA on the CPU
  may contract a multiply and an add into one FMA, and ``pow`` in the bias
  corrections may differ by an ulp;
- bf16 parameters: the float32 masters and slots at the same limits, the
  bf16 parameters within one bf16 ulp (atol 0, rtol 2^-7: a master next
  to a rounding boundary may round the other way).

ASGD with ``batch_num=3`` runs 6 steps with a poisoned grad at step 3
under the anomaly sentinel in both packages: the skipped step leaves the
ring, the running sum and the step count bit for bit as they were, and
the next step writes the same ring slot. RMSProp runs centered, with
momentum, and plain. Rprop raises ``TypeError`` under a scheduler. Each
step of these optimizers counts the frozen fallback reason "optimizer
rule has no fused kernel".

Under a scheduler (``LinearWarmup`` over ``CosineAnnealingDecay``, stepped
after every optimizer step): ``AdamW``, ``Momentum`` and ``Lamb`` take
the fused route bit for bit equal to the per-parameter route at float32,
the fused kernel's scalar vector reads the scheduler's lr at each step
(float32), the optimizer keeps one lr device scalar, and the parameters
track the reference at the limits above. ``AdamW(lr_ratio=...)`` is
accepted and, as in the reference, applied nowhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = [(8, 16), (130,), (4, 5)]
STEPS = 5
TOL = dict(atol=1e-6, rtol=1e-5)

# name -> (optimizer class name, keyword arguments)
RULES = {
    "adamax": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    "adadelta": ("Adadelta", dict(learning_rate=0.5, rho=0.9,
                                  weight_decay=0.01)),
    "asgd": ("ASGD", dict(learning_rate=0.05, batch_num=3,
                          weight_decay=0.01)),
    "rprop": ("Rprop", dict(learning_rate=0.01,
                            learning_rate_range=(1e-4, 0.05),
                            etas=(0.5, 1.2))),
    "adagrad": ("Adagrad", dict(learning_rate=0.05, weight_decay=0.01,
                                initial_accumulator_value=0.1)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, rho=0.9,
                                weight_decay=0.01)),
    "rmsprop_centered_momentum": ("RMSProp", dict(
        learning_rate=0.01, rho=0.9, momentum=0.9, centered=True,
        weight_decay=0.01)),
}


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    tflags.set_flags({"fused_optimizer": True, "anomaly_sentinel": False})
    paddle.set_flags({"FLAGS_fused_optimizer": True,
                      "FLAGS_anomaly_sentinel": False})


def _init():
    rng = np.random.RandomState(0)
    return [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]


def _grads(steps, poison=None):
    rng = np.random.RandomState(7)
    out = []
    for t in range(steps):
        gs = [rng.randn(*s).astype(np.float32) for s in SHAPES]
        if t == poison:
            gs[1][5] = np.nan
        out.append(gs)
    return out


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(0.02, T_max=6),
                          warmup_steps=2, start_lr=0.001, end_lr=0.02)


def _port(cls_name, kw, grads, bf16=False, clip=True, fused=True,
          sentinel=False):
    tflags.set_flags({"fused_optimizer": fused,
                      "anomaly_sentinel": sentinel})
    dt = torch.bfloat16 if bf16 else torch.float32
    params = [torch.nn.Parameter(torch.from_numpy(x).to(dt))
              for x in _init()]
    opt = getattr(TO, cls_name)(
        parameters=params, grad_clip=ClipGradByGlobalNorm(1.0) if clip
        else None, **kw)
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g).to(dt)
        opt.step()
        opt.clear_grad()
        if isinstance(opt._lr, tlr.LRScheduler):
            opt._lr.step()
    return params, opt


def _ref(cls_name, kw, grads, bf16=False, clip=True, sentinel=False):
    paddle.set_flags({"FLAGS_anomaly_sentinel": sentinel})
    params = [Tensor(x, stop_gradient=False) for x in _init()]
    if bf16:
        params = [Tensor(p._data.astype(jnp.bfloat16), stop_gradient=False)
                  for p in params]
    opt = getattr(JO, cls_name)(
        parameters=params, grad_clip=jnn.ClipGradByGlobalNorm(1.0) if clip
        else None, **kw)
    for gs in grads:
        for p, g in zip(params, gs):
            gd = jnp.asarray(g)
            p.grad = Tensor(gd.astype(jnp.bfloat16) if bf16 else gd)
        opt.step()
        opt.clear_grad()
        if isinstance(opt._lr, jlr.LRScheduler):
            opt._lr.step()
    return params, opt


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_tracks(tparams, topt, jparams, jopt, bf16):
    for i, (tp, jp) in enumerate(zip(tparams, jparams)):
        got = tp.detach().float().numpy()
        want = _np(jp._data)
        if bf16:
            np.testing.assert_allclose(got, want, atol=0, rtol=2.0 ** -7)
            np.testing.assert_allclose(topt._masters[i].numpy(),
                                       _np(jopt._masters[i]), **TOL)
        else:
            assert topt._masters[i] is None
            np.testing.assert_allclose(got, want, **TOL)
        tst, jst = topt._states[i], jopt._states[i]
        assert set(tst) == set(jst), (sorted(tst), sorted(jst))
        for k in jst:
            assert tuple(tst[k].shape) == tuple(jst[k].shape), k
            assert tst[k].dtype == torch.float32, k
            np.testing.assert_allclose(tst[k].numpy(), _np(jst[k]),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_tracks_reference(rule, bf16):
    cls_name, kw = RULES[rule]
    grads = _grads(STEPS)
    tparams, topt = _port(cls_name, kw, grads, bf16)
    jparams, jopt = _ref(cls_name, kw, grads, bf16)
    assert topt._step_count == jopt._step_count == STEPS
    _assert_tracks(tparams, topt, jparams, jopt, bf16)


@pytest.mark.parametrize("rule", sorted(RULES))
def test_each_step_counts_the_no_fused_kernel_reason(rule):
    cls_name, kw = RULES[rule]
    before = TO.fused_counters["fallbacks"]
    _, opt = _port(cls_name, kw, _grads(3))
    assert TO.fused_counters["fallbacks"] - before == 3
    assert opt._fused_last_reason == "optimizer rule has no fused kernel"
    assert opt._fused_last_reason in TO.FUSED_OPT_FALLBACK_REASONS


def test_asgd_skipped_step_leaves_the_ring_as_reference():
    cls_name, kw = RULES["asgd"]
    grads = _grads(6, poison=2)
    tparams, topt = _port(cls_name, kw, grads[:2], sentinel=True)
    before = {k: v.clone() for k, v in topt._states[1].items()}
    p_before = tparams[1].detach().clone()
    for p, g in zip(tparams, grads[2]):          # the poisoned step
        p.grad = torch.from_numpy(g)
    topt.step()
    topt.clear_grad()
    assert topt._step_count == 2
    for k, v in topt._states[1].items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(tparams[1].detach(), p_before)
    for gs in grads[3:]:
        for p, g in zip(tparams, gs):
            p.grad = torch.from_numpy(g)
        topt.step()
        topt.clear_grad()
    # step 3 (the next applied) wrote ring slot (3 - 1) % 3 = 2, step 5
    # slot 1: every slot holds a clipped grad
    assert all(bool(topt._states[0]["ys"][j].abs().sum() > 0)
               for j in range(3))
    jparams, jopt = _ref(cls_name, kw, grads, sentinel=True)
    assert topt._step_count == jopt._step_count == 5
    _assert_tracks(tparams, topt, jparams, jopt, bf16=False)


def test_rmsprop_mg_slot_only_when_centered():
    _, plain = _port("RMSProp", RULES["rmsprop"][1], _grads(1))
    _, centered = _port("RMSProp", RULES["rmsprop_centered_momentum"][1],
                        _grads(1))
    assert set(plain._states[0]) == {"ms", "mom"}
    assert set(centered._states[0]) == {"ms", "mom", "mg"}


def test_slots_start_at_their_initial_values():
    p = torch.nn.Parameter(torch.zeros(3, 4))
    ada = TO.Adagrad(learning_rate=0.1, parameters=[p],
                     initial_accumulator_value=0.25)
    rp = TO.Rprop(learning_rate=0.003, parameters=[p])
    asgd = TO.ASGD(learning_rate=0.1, parameters=[p], batch_num=4)
    for opt in (ada, rp, asgd):
        opt._create_state([0])
    assert torch.equal(ada._states[0]["acc"], torch.full((3, 4), 0.25))
    assert torch.equal(rp._states[0]["lrs"], torch.full((3, 4), 0.003))
    assert torch.equal(rp._states[0]["prev"], torch.zeros(3, 4))
    assert tuple(asgd._states[0]["ys"].shape) == (4, 3, 4)


def test_rprop_refuses_a_scheduler():
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(TypeError, match="LR schedulers do not apply"):
        TO.Rprop(learning_rate=tlr.StepDecay(0.1, 2), parameters=[p])
    with pytest.raises(TypeError):
        JO.Rprop(learning_rate=jlr.StepDecay(0.1, 2),
                 parameters=[Tensor(np.zeros(3, np.float32))])


def test_set_lr_raises_under_a_scheduler():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = TO.SGD(learning_rate=_sched(tlr), parameters=[p])
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    assert opt.get_lr() == _sched(tlr)()
    plain = TO.SGD(learning_rate=0.1, parameters=[p])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2


SCHEDULED = {
    "adamw": ("AdamW", dict(weight_decay=0.01)),
    "momentum": ("Momentum", dict(momentum=0.9, use_nesterov=True,
                                  weight_decay=0.01)),
    "lamb": ("Lamb", dict(lamb_weight_decay=0.01)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULED))
def test_scheduled_fused_equals_per_param_and_tracks_reference(name):
    cls_name, kw = SCHEDULED[name]
    grads = _grads(STEPS + 2)
    tflags.set_flags({"fused_optimizer": True})
    params = [torch.nn.Parameter(torch.from_numpy(x)) for x in _init()]
    opt = getattr(TO, cls_name)(learning_rate=_sched(tlr), parameters=params,
                                grad_clip=ClipGradByGlobalNorm(1.0), **kw)
    updates = TO.fused_counters["updates"]
    seen, want = [], []
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g)
        want.append(float(np.float32(opt.get_lr())))
        opt.step()
        opt.clear_grad()
        plan = next(iter(opt._fused_plans.values()))
        seen.append([float(b.svec[0]) for b in plan.buckets])
        opt._lr.step()
    assert TO.fused_counters["updates"] - updates == len(grads)
    assert all(s == [w] * len(s) for s, w in zip(seen, want)), (seen, want)
    assert len(set(want)) > 3                  # the lr did change
    assert [k for k in opt._live if k[0] == "lr"] == [("lr", "cpu")]
    per, _ = _port(cls_name, dict(kw, learning_rate=_sched(tlr)), grads,
                   fused=False)
    for a, b in zip(params, per):
        assert torch.equal(a.detach(), b.detach())
    jparams, _ = _ref(cls_name, dict(kw, learning_rate=_sched(jlr)), grads)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a.detach().numpy(), _np(b._data), **TOL)


def test_adamw_lr_ratio_is_accepted_and_unused():
    grads = _grads(3)
    kw = dict(learning_rate=0.01, weight_decay=0.01)
    with_ratio, opt = _port("AdamW", dict(kw, lr_ratio=lambda p: 0.5),
                            grads)
    without, _ = _port("AdamW", kw, grads)
    assert opt._lr_ratio is not None
    for a, b in zip(with_ratio, without):
        assert torch.equal(a.detach(), b.detach())
    assert JO.AdamW(parameters=[Tensor(np.zeros(2, np.float32))],
                    lr_ratio=lambda p: 0.5)._lr_ratio is not None


def test_asgd_trains_under_a_captured_train_step_as_eagerly():
    """ASGD picks its ring slot from the device step scalar, so a captured
    TrainStep (the CPU stand-in) runs it: six steps with a poisoned batch
    at step 3 under the anomaly sentinel are bit for bit the eager ones
    (``FLAGS_step_capture=0``): params, the running sum, the ring, and the
    step count once ``consume_anomaly`` has reconciled it."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.jit import step_capture as sc

    def run(capture):
        tflags.set_flags({"step_capture": capture, "anomaly_sentinel": True})
        try:
            torch.manual_seed(0)
            net = torch.nn.Linear(6, 3)
            opt = TO.ASGD(learning_rate=0.05, batch_num=3, weight_decay=0.01,
                          parameters=net.parameters())
            train = TrainStep(net, lambda out, y: (out - y).square().mean(),
                              opt)
            before = sc.capture_counters["captures"]
            for t in range(6):
                x = torch.from_numpy(np.random.RandomState(t).randn(4, 6)
                                     .astype(np.float32))
                if t == 2:
                    x[1, 3] = float("nan")
                train((x,), (torch.ones(4, 3),))
                opt.consume_anomaly()
            state = [v.clone() for st in opt._states for v in st.values()]
            return ([p.detach().clone() for p in net.parameters()], state,
                    opt._step_count,
                    sc.capture_counters["captures"] - before)
        finally:
            tflags.set_flags({"step_capture": True,
                              "anomaly_sentinel": False})

    pe, se, ne, _ = run(False)
    pc, sc_, nc, captures = run(True)
    assert captures == 1
    assert ne == nc == 5
    assert all(torch.equal(a, b) for a, b in zip(pe, pc))
    assert all(torch.equal(a, b) for a, b in zip(se, sc_))
