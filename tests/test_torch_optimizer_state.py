"""Optimizer state: ``state_dict`` / ``set_state_dict`` and the carry of
the JAX package's optimizer state into the port.

- ``state_dict`` returns copies: later steps leave it as it was.
- A resume within the port is bit for bit: 3 steps, ``state_dict`` and
  the weights taken, 3 more steps; a new optimizer over the saved weights
  with ``set_state_dict`` takes the same 3 steps to the same bits (the
  losses' stand-in: the parameters, masters and slots after each step),
  on the fused route and on the per-parameter route, under a scheduler,
  with bf16 parameters and float32 masters.
- The reference's ``state_dict`` (arrays as numpy) carried into the port
  by ``models.convert.from_jax_optimizer_state``: the Llama-tiny model
  (float32) takes 2 ``AdamW`` steps under a scheduler in the JAX package,
  its weights and optimizer state move across, and 3 more steps in both
  packages match: losses atol 1e-5, parameters atol 1e-4 with all but 1
  in 10^4 elements within 1e-5 (the limits of
  ``tests/test_torch_llama_training.py``: Adam turns a 1e-4 relative
  grad difference on a near-zero grad into another direction). The same
  with bf16 parameters, masters, and ASGD's ring ``[batch_num, *shape]``
  over plain tensors: masters and slots atol 1e-6, rtol 1e-5.
- A planted fault, the lr device scalar never refreshed, is caught: the
  fused kernel's scalar vector then reads a stale lr, which the lr check
  sees, and the parameters leave the unfaulted run's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_optimizer_state,
                                     from_jax_state_dict,
                                     named_optimizer_state)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as tlr

SHAPES = [(8, 16), (130,), (4, 5)]
TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    tflags.set_flags({"fused_optimizer": True})


@pytest.fixture(autouse=True)
def _no_tp():
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(saved)


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(0.02, T_max=6),
                          warmup_steps=2, start_lr=0.001, end_lr=0.02)


def _init():
    rng = np.random.RandomState(0)
    return [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]


def _grads(steps, seed=7):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(np.float32) for s in SHAPES]
            for _ in range(steps)]


OPTS = {
    "adamw": lambda m, ps: TO.AdamW(learning_rate=_sched(m), parameters=ps,
                                    weight_decay=0.01,
                                    grad_clip=ClipGradByGlobalNorm(1.0)),
    "lamb": lambda m, ps: TO.Lamb(learning_rate=_sched(m), parameters=ps,
                                  grad_clip=ClipGradByGlobalNorm(1.0)),
    "asgd": lambda m, ps: TO.ASGD(learning_rate=_sched(m), parameters=ps,
                                  batch_num=2, weight_decay=0.01),
}


def _steps(params, opt, grads, dt):
    out = []
    for gs in grads:
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g).to(dt)
        opt.step()
        opt.clear_grad()
        opt._lr.step()
        out.append(([p.detach().clone() for p in params],
                    opt.state_dict()))
    return out


def _equal_state(a, b):
    assert a["step"] == b["step"] and a.get("lr") == b.get("lr")
    for x, y in zip(a["masters"], b["masters"]):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(a["states"], b["states"]):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_state_dict_returns_copies():
    params = [torch.nn.Parameter(torch.from_numpy(x)) for x in _init()]
    opt = OPTS["adamw"](tlr, params)
    (_, sd), = _steps(params, opt, _grads(1), torch.float32)
    snap = {k: v.clone() for k, v in sd["states"][0].items()}
    _steps(params, opt, _grads(2, seed=8), torch.float32)
    for k, v in sd["states"][0].items():
        assert torch.equal(v, snap[k])
        assert v.data_ptr() != opt._states[0][k].data_ptr()
    assert sd["step"] == 1 and opt._step_count == 3


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_param"])
@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_resume_is_bitwise(name, fused, dt):
    tflags.set_flags({"fused_optimizer": fused})
    grads = _grads(6)
    params = [torch.nn.Parameter(torch.from_numpy(x).to(dt))
              for x in _init()]
    opt = OPTS[name](tlr, params)
    _steps(params, opt, grads[:3], dt)
    sd = opt.state_dict()
    weights = [p.detach().clone() for p in params]
    first = _steps(params, opt, grads[3:], dt)

    params2 = [torch.nn.Parameter(w.clone()) for w in weights]
    opt2 = OPTS[name](tlr, params2)
    opt2.set_state_dict(sd)
    assert opt2._step_count == 3 and opt2._lr.state_dict() == sd["lr"]
    second = _steps(params2, opt2, grads[3:], dt)
    for (pa, sa), (pb, sb) in zip(first, second):
        for a, b in zip(pa, pb):
            assert torch.equal(a, b)
        _equal_state(sa, sb)
    if name != "asgd" and fused:
        assert opt2._fused_last_reason is None


def _llama_pair():
    paddle.seed(0)
    jm = JModel(JConfig(**dataclasses.asdict(JConfig.tiny())))
    jm.train()
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    return jm, tm


def _ids(seed):
    return np.random.RandomState(seed).randint(0, 256, (2, 64)) \
        .astype(np.int32)


def test_reference_state_carries_into_the_port():
    jm, tm = _llama_pair()
    jopt = JO.AdamW(learning_rate=_sched(jlr), weight_decay=0.01,
                    parameters=jm.parameters(),
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    crit = JCrit()

    def jstep(ids):
        loss = crit(jm(Tensor(ids)), Tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jopt._lr.step()
        return float(loss._data)

    for s in range(2):
        jstep(_ids(s))
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    jsd = jopt.state_dict()
    state = {"step": jsd["step"], "lr": jsd["lr"],
             "states": [None if s is None else
                        {k: np.asarray(v) for k, v in s.items()}
                        for s in jsd["states"]],
             "masters": [None if m is None else np.asarray(m)
                         for m in jsd["masters"]]}
    names = [n for n, _ in jm.named_parameters()]
    topt = TO.AdamW(learning_rate=_sched(tlr), weight_decay=0.01,
                    parameters=tm.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
    from_jax_optimizer_state(tm, topt, state, names)
    assert topt._step_count == 2 and topt.get_lr() == jopt.get_lr()
    carried = named_optimizer_state(tm, topt)
    for j, n in enumerate(names):
        for k in ("m", "v"):
            np.testing.assert_array_equal(carried[n][k],
                                          np.asarray(jsd["states"][j][k]))
    train = TrainStep(tm, LlamaPretrainingCriterion(), topt)
    for s in range(2, 5):
        t_ids = torch.from_numpy(_ids(s))
        tl = float(train((t_ids,), (t_ids,)))
        topt._lr.step()
        assert abs(tl - jstep(_ids(s))) < 1e-5
    diff = np.concatenate([
        np.abs(p.detach().numpy() - np.asarray(jp._data)).ravel()
        for (_, p), (_, jp) in zip(tm.named_parameters(),
                                   jm.named_parameters())])
    assert diff.max() < 1e-4
    assert (diff > 1e-5).mean() < 1e-4


class _Params(torch.nn.Module):
    def __init__(self, arrays, dt):
        super().__init__()
        for i, a in enumerate(arrays):
            self.register_parameter(
                f"w{i}",
                torch.nn.Parameter(torch.from_numpy(np.array(a)).to(dt)))


@pytest.mark.parametrize("name", ["ASGD", "Adamax", "AdamW"])
def test_reference_masters_and_slots_carry_over_plain_tensors(name):
    kw = {"ASGD": dict(batch_num=3, weight_decay=0.01),
          "Adamax": dict(weight_decay=0.01),
          "AdamW": dict(weight_decay=0.01)}[name]
    grads = _grads(5)
    jps = [Tensor(jnp.asarray(x).astype(jnp.bfloat16), stop_gradient=False)
           for x in _init()]
    jopt = getattr(JO, name)(learning_rate=0.01, parameters=jps, **kw)

    def jstep(gs):
        for p, g in zip(jps, gs):
            p.grad = Tensor(jnp.asarray(g).astype(jnp.bfloat16))
        jopt.step()
        jopt.clear_grad()

    for gs in grads[:2]:
        jstep(gs)
    jsd = jopt.state_dict()
    model = _Params([np.asarray(p._data.astype(jnp.float32)) for p in jps],
                    torch.bfloat16)
    topt = getattr(TO, name)(learning_rate=0.01,
                             parameters=list(model.parameters()), **kw)
    state = {"step": jsd["step"],
             "states": [{k: np.asarray(v) for k, v in s.items()}
                        for s in jsd["states"]],
             "masters": [np.asarray(m) for m in jsd["masters"]]}
    names = [f"w{i}" for i in range(len(jps))][::-1]   # any order, by name
    state["states"] = state["states"][::-1]
    state["masters"] = state["masters"][::-1]
    from_jax_optimizer_state(model, topt, state, names)
    if name == "ASGD":
        assert tuple(topt._states[0]["ys"].shape) == (3,) + SHAPES[0]
    for gs in grads[2:]:
        for p, g in zip(model.parameters(), gs):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        topt.step()
        topt.clear_grad()
        jstep(gs)
    for i in range(len(jps)):
        np.testing.assert_allclose(topt._masters[i].numpy(),
                                   np.asarray(jopt._masters[i]), **TOL)
        for k, v in jopt._states[i].items():
            np.testing.assert_allclose(topt._states[i][k].numpy(),
                                       np.asarray(v), err_msg=k, **TOL)
    named = named_optimizer_state(model, topt)
    if name == "ASGD":
        assert named["w0"]["ys"].shape == (3,) + SHAPES[0]


def test_set_state_dict_refuses_a_mismatch():
    params = [torch.nn.Parameter(torch.from_numpy(x)) for x in _init()]
    opt = OPTS["adamw"](tlr, params)
    sd = opt.state_dict()
    with pytest.raises(ValueError, match="lists"):
        opt.set_state_dict(dict(sd, states=sd["states"][:1]))
    bad = [None, {"m": torch.zeros(3), "v": torch.zeros(3)}, None]
    with pytest.raises(ValueError, match="shape"):
        opt.set_state_dict(dict(sd, states=bad))
    with pytest.raises(KeyError, match="slots"):
        opt.set_state_dict(dict(sd, states=[None, {"m": torch.zeros(130)},
                                            None]))


def _scheduled_run(steps):
    params = [torch.nn.Parameter(torch.from_numpy(x)) for x in _init()]
    opt = OPTS["adamw"](tlr, params)
    seen, want = [], []
    for gs in _grads(steps):
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g)
        want.append(float(np.float32(opt.get_lr())))
        opt.step()
        opt.clear_grad()
        plan = next(iter(opt._fused_plans.values()))
        seen.append(float(plan.buckets[0].svec[0]))
        opt._lr.step()
    return params, seen, want


def test_a_stale_lr_scalar_is_caught(monkeypatch):
    good, seen, want = _scheduled_run(5)
    assert seen == want
    monkeypatch.setattr(TO.Optimizer, "_refresh",
                        staticmethod(lambda t, value: None))
    bad, seen_bad, want_bad = _scheduled_run(5)
    assert want_bad == want
    assert seen_bad != want_bad and seen_bad == [want[0]] * 5
    assert any(not torch.equal(a, b) for a, b in zip(good, bad))
