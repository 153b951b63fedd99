"""Paddle's eager loop through the port's ``Tensor`` boundary.

The canonical dygraph loop (``paddle.seed``, ids from ``paddle.randint``
or ``paddle.to_tensor``, ``loss = crit(model(x), x)``, ``loss.backward()``,
``opt.step()``, ``opt.clear_grad()``, ``loss.item()``) written once as
user code and run:

- through both packages on a tiny Llama (2 layers, hidden 64) whose port
  weights are the reference's (``from_jax_state_dict``), 3 AdamW + global
  norm clip steps: each step's loss within atol 1e-5 and the first step's
  grads within 1e-4 of the tensor's max, as
  ``tests/test_torch_llama_training.py`` holds the plain path;
- in the port with ``Tensor`` inputs and with plain inputs: the losses
  and the weights equal bit for bit;
- under a ``torch.overrides.TorchFunctionMode`` that records every torch
  call of the model's forward: none of them receives a ``Tensor`` (the
  model's call unwraps it), and the model returns a ``Tensor``;
- through ``jit_step`` (the README's example): ``Tensor`` inputs replay
  the same losses as plain ones.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch.core.tensor import Tensor

SEQ = 64


@pytest.fixture(autouse=True)
def _cpu_single_device():
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    prev = paddle_tpu_torch.get_device()
    paddle_tpu_torch.set_device("cpu")
    yield
    paddle_tpu_torch.set_device(prev)
    topology.set_hybrid_communicate_group(saved)


def _ids(seed=0, b=2, s=SEQ, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype(np.int32)


def _models():
    from paddle_tpu.models import LlamaConfig as JConfig
    from paddle_tpu.models import LlamaForCausalLM as JModel
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         from_jax_state_dict)
    paddle_tpu.seed(0)
    jm = JModel(JConfig.tiny())
    jm.train()
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def paddle_loop(P, model, crit, ids, steps=3):
    """The user's loop, the same for both packages."""
    opt = P.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                            parameters=model.parameters(),
                            grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    x = P.to_tensor(ids)
    losses, grads = [], None
    for i in range(steps):
        loss = crit(model(x), x)
        loss.backward()
        if i == 0:
            grads = {n: np.asarray(p.grad.numpy())
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, grads


def test_paddle_loop_tracks_the_reference():
    from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    jm, tm = _models()
    ids = _ids()
    jl, jg = paddle_loop(paddle_tpu, jm, JCrit(), ids)
    tl, tg = paddle_loop(paddle_tpu_torch, tm, LlamaPretrainingCriterion(),
                         ids)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert set(tg) == set(jg)
    for n in jg:
        rel = np.abs(tg[n] - jg[n]).max() / max(np.abs(jg[n]).max(), 1e-30)
        assert rel < 1e-4, (n, rel)


def _port_run(tensor_inputs, steps=3):
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    P = paddle_tpu_torch
    gen = torch.Generator().manual_seed(3)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", generator=gen)
    crit = LlamaPretrainingCriterion()
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    P.seed(5)
    ids = P.randint(0, 256, [2, SEQ + 1])
    x = ids[:, :-1] if tensor_inputs else ids[:, :-1].as_subclass(
        torch.Tensor)
    assert isinstance(x, Tensor) == tensor_inputs
    losses = []
    for _ in range(steps):
        logits = model(x)
        assert isinstance(logits, Tensor) == tensor_inputs
        loss = crit(logits, x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, [p.detach().clone() for p in model.parameters()]


def test_tensor_inputs_equal_plain_inputs_bit_for_bit():
    a_losses, a_params = _port_run(True)
    b_losses, b_params = _port_run(False)
    assert a_losses == b_losses
    assert all(torch.equal(a, b) for a, b in zip(a_params, b_params))


class _Recorder(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls, self.saw_tensor = 0, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls += 1
        stack = list(args) + list(kwargs.values())
        while stack:
            v = stack.pop()
            if isinstance(v, Tensor):
                self.saw_tensor.append(getattr(func, "__name__", str(func)))
            elif isinstance(v, (list, tuple)):
                stack.extend(v)
            elif isinstance(v, dict):
                stack.extend(v.values())
        return func(*args, **kwargs)


def test_no_port_internal_receives_a_tensor():
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    P = paddle_tpu_torch
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    x = P.to_tensor(_ids())
    rec = _Recorder()
    with rec:
        logits = model(x)
        loss = LlamaPretrainingCriterion()(logits, x)
    assert rec.calls > 100 and rec.saw_tensor == []
    assert isinstance(logits, Tensor) and isinstance(loss, Tensor)
    lin = P.nn.Linear(4, 3)
    rec = _Recorder()
    with rec:
        out = lin(P.to_tensor(np.ones((2, 4), np.float32)))
    assert rec.saw_tensor == [] and isinstance(out, Tensor)


def test_readme_jit_step_takes_tensor_inputs():
    from paddle_tpu_torch.jit import jit_step
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    P = paddle_tpu_torch
    batches = [_ids(seed) for seed in range(4)]
    runs = []
    for as_tensor in (True, False):
        gen = torch.Generator().manual_seed(1)
        model = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny()),
                                 device="cpu", generator=gen)
        crit = LlamaPretrainingCriterion()
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())

        @jit_step
        def step(ids):
            loss = crit(model(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        losses = []
        for b in batches:
            ids = P.to_tensor(b) if as_tensor else torch.from_numpy(
                b.astype(np.int64))
            out = step(ids)
            assert isinstance(out, Tensor) == as_tensor
            losses.append(float(out))
        runs.append(losses)
    assert runs[0] == runs[1]


def test_train_step_takes_tensor_inputs():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    P = paddle_tpu_torch
    runs = []
    for as_tensor in (True, False):
        gen = torch.Generator().manual_seed(2)
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                 generator=gen)
        train = TrainStep(model, LlamaPretrainingCriterion(),
                          AdamW(learning_rate=1e-3,
                                parameters=model.parameters()))
        ids = P.to_tensor(_ids(7))
        if not as_tensor:
            ids = ids.as_subclass(torch.Tensor)
        outs = [train((ids,), (ids,)) for _ in range(3)]
        assert all(isinstance(o, Tensor) == as_tensor for o in outs)
        runs.append([float(o) for o in outs])
    assert runs[0] == runs[1]


def test_reference_loop_runs_the_same_user_code():
    """The loop above is the reference's own idiom: its Tensor comes from
    the same calls (a sanity check of the shared script)."""
    assert isinstance(paddle_tpu.to_tensor(_ids()), JTensor)
