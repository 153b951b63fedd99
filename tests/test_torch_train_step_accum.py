"""``TrainStep(grad_accum=, amp_level=)`` against the JAX package's
``TrainStep``.

The Llama-tiny model (seq 64) with ``AdamW`` under a scheduler
(``LinearWarmup`` over ``CosineAnnealingDecay``, stepped after each
optimizer step), a global-norm clip and ``grad_accum=2`` over two
different micro-batches takes 3 optimizer steps (6 calls) in both
packages on the same weights and ids:

- float32, no AMP: every call's loss atol 1e-5 (each call returns its own
  micro-batch's loss); every parameter atol 1e-4 and all but 1 in 10^4
  elements within 1e-5 (the limits of
  ``tests/test_torch_llama_training.py``);
- ``amp_level="O1"`` over float32 weights, and ``"O2"`` over weights
  ``decorate``d to bf16: losses atol 2e-3 (bf16 products), and each
  weight's 3-step update (the masters' under O2) points the reference's
  way, cosine >= 0.9 (Adam turns bf16 grad differences into sign flips of
  small updates).

Within the port: a micro step launches no optimizer update (one fused
update per window); the fused route, which folds ``1/grad_accum`` into the
kernel's unscale scalar, equals the per-parameter route, which divides
the grads, bit for bit for ``grad_accum=2`` (a power of two); for
``grad_accum=3`` the folded multiply by ``1/3`` rounds ``1/3`` to the
grad's dtype first: the mean grads it gives stay within one ulp of the
divide's (bf16 and float32), and three float32 AdamW steps of the two
routes within atol 1e-6. The reference's own accumulation test
(``tests/test_io_amp_jit.py::test_trainstep_grad_accum``: SGD over a
biased linear layer, MSE) is mirrored at its limits (rtol 1e-5, atol
1e-6).
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
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict,
                                     named_optimizer_state)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import fused_optimizer as fok
from paddle_tpu_torch.optimizer import lr as tlr

SEQ = 64


@pytest.fixture(autouse=True)
def _env():
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(saved)
    tflags.set_flags({"fused_optimizer": True})


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(2e-3, T_max=4),
                          warmup_steps=2, start_lr=5e-4, end_lr=2e-3)


def _pair():
    paddle.seed(0)
    jm = JModel(JConfig(**dataclasses.asdict(JConfig.tiny())))
    jm.train()
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _batches():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 256, (2, SEQ)).astype(np.int32) for _ in range(2)]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_train(jm, level, steps=3):
    if level == "O2":
        paddle.amp.decorate(jm, level="O2")
    opt = JO.AdamW(learning_rate=_sched(jlr), weight_decay=0.01,
                   parameters=jm.parameters(),
                   grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    train = paddle.jit.TrainStep(jm, JCrit(), opt, grad_accum=2,
                                 amp_level=level)
    losses = []
    for _ in range(steps):
        for ids in _batches():
            losses.append(float(train(Tensor(ids), Tensor(ids))._data))
        opt._lr.step()
    names = [n for n, _ in jm.named_parameters()]
    params = {n: _np(p._data) for n, p in jm.named_parameters()}
    masters = {n: _np(m) for n, m in zip(names, opt._masters)
               if m is not None}
    return losses, params, masters


def _port_train(tm, level, steps=3, accum=2, fused=True):
    tflags.set_flags({"fused_optimizer": fused})
    if level == "O2":
        tamp.decorate(tm, level="O2")
    opt = TO.AdamW(learning_rate=_sched(tlr), weight_decay=0.01,
                   parameters=tm.parameters(),
                   grad_clip=ClipGradByGlobalNorm(1.0))
    train = TrainStep(tm, LlamaPretrainingCriterion(), opt,
                      grad_accum=accum, amp_level=level)
    losses, updates = [], []
    batches = _batches()
    for _ in range(steps):
        for k in range(accum):
            ids = torch.from_numpy(batches[k % 2])
            before = TO.fused_counters["updates"]
            losses.append(float(train((ids,), (ids,))))
            updates.append(TO.fused_counters["updates"] - before)
        opt._lr.step()
    return losses, updates, opt


def test_float32_accumulation_tracks_reference():
    jm, tm = _pair()
    jlosses, jparams, _ = _jax_train(jm, None)
    tlosses, updates, _ = _port_train(tm, None)
    assert updates == [0, 1] * 3       # no update on a micro step
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)
    assert tlosses[0] != tlosses[1]    # each call its own micro-batch
    diff = np.concatenate([np.abs(p.detach().numpy() - jparams[n]).ravel()
                           for n, p in tm.named_parameters()])
    assert diff.max() < 1e-4
    assert (diff > 1e-5).mean() < 1e-4


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_accumulation_tracks_reference(level):
    jm, tm = _pair()
    start = {n: p.detach().float().numpy().copy()
             for n, p in tm.named_parameters()}
    jlosses, jparams, jmasters = _jax_train(jm, level)
    tlosses, updates, opt = _port_train(tm, level)
    assert updates == [0, 1] * 3
    np.testing.assert_allclose(tlosses, jlosses, atol=2e-3, rtol=0)
    if level == "O2":
        state = named_optimizer_state(tm, opt)
        assert set(state) == set(jmasters)
        got = {n: s["master"] for n, s in state.items()}
        want = jmasters
        assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    else:
        got = {n: p.detach().numpy() for n, p in tm.named_parameters()}
        want = jparams
        assert all(p.dtype == torch.float32 for p in tm.parameters())
    for n in want:
        a, b = got[n] - start[n], want[n] - start[n]
        cos = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
        assert cos >= 0.9, (n, cos)


def _routes(accum, steps=3):
    out = []
    for fused in (True, False):
        _, tm = _pair()
        fb = TO.fused_counters["fallbacks"]
        losses, _, _ = _port_train(tm, None, steps=steps, accum=accum,
                                   fused=fused)
        assert (TO.fused_counters["fallbacks"] == fb) == fused
        out.append((losses, [p.detach().clone() for p in tm.parameters()]))
    return out


def test_folded_mean_equals_divided_mean_for_two():
    (la, pa), (lb, pb) = _routes(2)
    assert la == lb
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


def test_folded_mean_for_three_stays_within_an_ulp():
    (la, pa), (lb, pb) = _routes(3, steps=2)
    np.testing.assert_allclose(la, lb, atol=1e-6, rtol=0)
    for a, b in zip(pa, pb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    rng = np.random.RandomState(3)
    inv = TO.optimizer.inv_scale(torch.tensor(3.0))
    for dt, mant in ((torch.bfloat16, 7), (torch.float32, 23)):
        g = torch.from_numpy(rng.randn(4096).astype(np.float32) * 3).to(dt)
        folded = fok.condition_grad(g, inv).double()
        divided = (g / 3).double()
        ulp = 2.0 ** (torch.floor(torch.log2(divided.abs())) - mant)
        assert float(((folded - divided).abs() / ulp).max()) <= 1.0


class _Linear(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(np.array(w)))
        self.bias = torch.nn.Parameter(torch.from_numpy(np.array(b)))

    def forward(self, x):
        return torch.matmul(x, self.weight) + self.bias


def _mse(out, y):
    return ((out - y) ** 2).mean()


def test_reference_grad_accum_test_mirrored():
    f32 = lambda *s: np.random.RandomState(sum(s)).rand(*s).astype(  # noqa
        np.float32)

    def build():
        paddle.seed(7)
        m = jnn.Linear(4, 2)
        return m, JO.SGD(learning_rate=0.1, parameters=m.parameters(),
                         multi_precision=False)

    X1, X2 = f32(8, 4), f32(8, 4) + 1.0
    Y1, Y2 = f32(8, 2), f32(8, 2)
    m1, o1 = build()
    l1 = jnn.MSELoss()(m1(Tensor(X1)), Tensor(Y1))
    l2 = jnn.MSELoss()(m1(Tensor(X2)), Tensor(Y2))
    ((l1 + l2) / 2.0).backward()
    o1.step()
    m2, _ = build()
    tm = _Linear(np.asarray(m2.weight._data), np.asarray(m2.bias._data))
    opt = TO.SGD(learning_rate=0.1, parameters=tm.parameters(),
                 multi_precision=False)
    train = TrainStep(tm, _mse, opt, grad_accum=2)
    train(torch.from_numpy(X1), torch.from_numpy(Y1))
    assert tm.weight.grad is not None            # accumulating
    train(torch.from_numpy(X2), torch.from_numpy(Y2))
    assert tm.weight.grad is None                # applied and cleared
    np.testing.assert_allclose(np.asarray(m1.weight._data),
                               tm.weight.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(m1.bias._data),
                               tm.bias.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_grad_accum_must_be_positive():
    with pytest.raises(ValueError, match="grad_accum"):
        TrainStep(torch.nn.Linear(2, 2), _mse, None, grad_accum=0)
