"""Multi-step capture (``paddle_tpu_torch.jit.multi_step``) on the CPU
stand-in, against the contract of the reference's
``tests/test_multi_step.py``.

- A K-step block is BIT FOR BIT K single steps (``torch.equal`` on the
  weights, the optimizer state and the masters; the losses equal), for
  SGD, Adam and AdamW, plain, under a scheduler stepped inside the step,
  with a global-norm clip and over bf16 params; each against eager steps
  and against single-step capture. Step counts and the scheduler's lr
  after the run equal too.
- The lr stack a block reads is the scheduler's value at each of its K
  steps (the shadow scheduler), and the host scheduler is left as the K
  host advances put it.
- The epoch tail: ``hapi.Model.fit`` over 11 batches with K = 4 trains 2
  blocks (the first probes, so 1 counts as a captured block) and 3
  single-step tail steps, and its losses and weights equal single-step
  ``fit``'s bit for bit. A callback that overrides the per-batch hooks
  keeps ``fit`` on single steps, counted as a block fallback.
- With ``FLAGS_step_capture`` off a block runs K eager steps.
- A malformed block raises; ``MULTI_STEP_FALLBACK_REASONS`` equals the
  reference's; ``record_block_fallback`` refuses a reason outside it.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.jit import multi_step as jms
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.hapi import Model, callbacks
from paddle_tpu_torch.jit import jit_step, multi_step as ms
from paddle_tpu_torch.jit import step_capture as sc
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

K = 3


@pytest.fixture(autouse=True)
def _flags():
    tflags.set_flags({"step_capture": True, "multi_step": 0})
    yield
    tflags.set_flags({"step_capture": True, "multi_step": 0})


def f32(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _build(opt_name, variant):
    g = torch.Generator().manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 3))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    if variant == "bf16":
        net.to(torch.bfloat16)
    lr = TO.lr.StepDecay(0.05, step_size=2, gamma=0.5) \
        if variant == "sched" else 0.05
    clip = ClipGradByGlobalNorm(1.0) if variant == "clip" else None
    opt = {"sgd": TO.SGD, "adam": TO.Adam, "adamw": TO.AdamW}[opt_name](
        learning_rate=lr, parameters=net.parameters(), grad_clip=clip)

    def step(x, y):
        out = net(x.to(next(net.parameters()).dtype)).float()
        loss = torch.nn.functional.cross_entropy(out, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if variant == "sched":
            lr.step()
        return loss.detach()

    return net, opt, step


def _batches(n):
    xs = [torch.from_numpy(f32(i, 8, 6)) for i in range(n)]
    ys = [torch.from_numpy(np.random.RandomState(100 + i).randint(
        0, 3, 8)) for i in range(n)]
    return xs, ys


def _state(net, opt):
    return ([p.detach().clone() for p in net.parameters()],
            [dict(s) for s in opt._states], list(opt._masters),
            opt._step_count, opt.get_lr())


def _same(a, b):
    pa, sa, ma, ca, la = a
    pb, sb, mb, cb, lb = b
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    for x, y in zip(sa, sb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for x, y in zip(ma, mb):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)
    assert (ca, la) == (cb, lb)


@pytest.mark.parametrize("variant", ["plain", "sched", "clip", "bf16"])
@pytest.mark.parametrize("opt_name", ["sgd", "adam", "adamw"])
def test_block_equals_k_single_steps(opt_name, variant):
    blocks = 4
    xs, ys = _batches(blocks * K)
    net_e, opt_e, step_e = _build(opt_name, variant)
    le = [float(step_e(x, y)) for x, y in zip(xs, ys)]
    net_s, opt_s, step_s = _build(opt_name, variant)
    single = jit_step(step_s)
    ls = [float(single(x, y)) for x, y in zip(xs, ys)]
    net_m, opt_m, step_m = _build(opt_name, variant)
    multi = jit_step(step_m, k_steps=K)
    before = dict(ms.multi_counters)
    lm = []
    for b in range(blocks):
        out = multi(torch.stack(xs[b * K:(b + 1) * K]),
                    torch.stack(ys[b * K:(b + 1) * K]))
        assert tuple(out.shape) == (K,)
        lm += out.tolist()
    # block 1 probes, block 2 warms up and captures, 3 and 4 replay
    assert ms.multi_counters["blocks"] - before["blocks"] == 3
    assert ms.multi_counters["replays"] - before["replays"] == 2
    assert le == ls == lm
    _same(_state(net_e, opt_e), _state(net_m, opt_m))
    _same(_state(net_s, opt_s), _state(net_m, opt_m))


def test_lr_stack_follows_the_scheduler():
    net, opt, step = _build("sgd", "sched")
    multi = jit_step(step, k_steps=4)
    xs, ys = _batches(12)
    seen = []
    for b in range(3):
        want = []
        sched = opt._lr
        shadow = TO.lr.StepDecay(0.05, step_size=2, gamma=0.5)
        shadow.set_state_dict(sched.state_dict())
        for _ in range(4):
            want.append(shadow())
            shadow.step()
        multi(torch.stack(xs[4 * b:4 * b + 4]),
              torch.stack(ys[4 * b:4 * b + 4]))
        ent = [e for e in multi._entries.values()
               if isinstance(e, sc._Entry)]
        if ent:
            seen.append((ent[0].lr_stacks[id(opt)].tolist(), want))
    assert len(seen) == 2                     # the capture's and a replay's
    for got, want in seen:
        np.testing.assert_array_equal(got, np.float32(want))
    assert opt._lr.last_epoch == 12 and opt._step_count == 12


def test_malformed_block_raises():
    _, _, step = _build("sgd", "plain")
    multi = jit_step(step, k_steps=K)
    with pytest.raises(ValueError, match="leading"):
        multi(torch.zeros(K + 1, 8, 6), torch.zeros(K, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="k_steps"):
        ms.MultiStepCapture(step, 1)


def test_reasons_equal_the_reference():
    assert ms.MULTI_STEP_FALLBACK_REASONS == jms.MULTI_STEP_FALLBACK_REASONS
    with pytest.raises(ValueError, match="unregistered"):
        ms.record_block_fallback("not a reason")
    b = ms.multi_counters["fallbacks"]
    ms.record_block_fallback("ring block shorter than k_steps (epoch tail)")
    assert ms.multi_counters["fallbacks"] == b + 1


def test_flag_off_runs_k_eager_steps():
    tflags.set_flags({"step_capture": False})
    net_e, opt_e, step_e = _build("adam", "plain")
    net_m, opt_m, step_m = _build("adam", "plain")
    multi = jit_step(step_m, k_steps=K)
    xs, ys = _batches(2 * K)
    le = [float(step_e(x, y)) for x, y in zip(xs, ys)]
    lm = []
    for b in range(2):
        lm += multi(torch.stack(xs[b * K:(b + 1) * K]),
                    torch.stack(ys[b * K:(b + 1) * K])).tolist()
    assert le == lm and multi.last_fallback == "FLAGS_step_capture disabled"
    _same(_state(net_e, opt_e), _state(net_m, opt_m))


def _fit(k, samples=44, batch=4):
    tflags.set_flags({"multi_step": k})
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 3))
    opt = TO.Adam(learning_rate=0.05, parameters=net.parameters())
    m = Model(net)
    m.prepare(opt, torch.nn.CrossEntropyLoss())
    rng = np.random.RandomState(0)
    x = rng.randn(samples, 6).astype(np.float32)
    y = rng.randint(0, 3, samples).astype(np.int64)
    np.random.seed(1)
    loader = tio.DataLoader(tio.TensorDataset([x, y]), places="cpu",
                            batch_size=batch, shuffle=True)
    losses = []

    class Record(callbacks.ProgBarLogger):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    m.fit(loader, epochs=1, verbose=0, callbacks=[Record(verbose=0)])
    return losses, [p.detach().clone() for p in net.parameters()]


def test_fit_epoch_tail_runs_single_steps():
    before = dict(ms.multi_counters)
    lm, pm = _fit(4)
    d = {k: ms.multi_counters[k] - before[k] for k in before}
    assert d["blocks"] == 1 and d["tail_steps"] == 3   # 11 = 2 x 4 + 3
    ls, ps = _fit(0)
    assert lm == ls and len(lm) == 11
    assert all(torch.equal(a, b) for a, b in zip(pm, ps))


def test_per_step_callback_keeps_fit_on_single_steps():
    before = ms.multi_counters["fallbacks"]

    class Steer(callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            pass

    tflags.set_flags({"multi_step": 4})
    net = torch.nn.Linear(6, 3)
    m = Model(net)
    m.prepare(TO.SGD(learning_rate=0.1, parameters=net.parameters()),
              torch.nn.CrossEntropyLoss())
    data = tio.TensorDataset([f32(0, 8, 6), np.zeros(8, np.int64)])
    m.fit(tio.DataLoader(data, places="cpu", batch_size=2), verbose=0,
          callbacks=[Steer()])
    assert ms.multi_counters["fallbacks"] == before + 1
    assert m._multi_step is None
    assert sc.capture_counters["captures"] >= 1
