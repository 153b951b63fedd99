"""Activation recomputation (``paddle_tpu_torch.distributed.recompute``)
and ``LlamaConfig(recompute=...)`` against the JAX package's, at a tiny
size.

The JAX tiny Llama (hidden 64, 4/2 heads, 2 layers, vocab 256) is built
from its seed with ``recompute="selective"`` and its weights move across;
both see the same token ids (numpy, seeded) at seq 128. Held to the
reference, float32: the logits and loss atol 1e-5 and every grad within
1e-4 of the tensor's max (``test_torch_llama_training.py``'s limits), for
each of the port's ``recompute`` modes (False, True, "selective").

Held within the port: the three modes give the same logits and grads BIT
FOR BIT (the recompute runs the same ops in the same order), and a
``recompute`` segment with a Dropout under it gives the grads of the same
segment run plainly (its explicit generator is rewound for the
recompute and left where the forward left it).

What selective keeps: saved-tensor hooks around the forward see every
tensor the autograd graph saves outside a checkpoint (none inside it, the
checkpoint's own hooks hold those); with recompute on, each layer saves
nothing through them. The matrix products' outputs are the policy's: in
the backward a "selective" step runs no ``aten.mm`` of the forward again
(the backward's mm count equals the no-recompute step's) and re-runs the
elementwise ops (``rsqrt``, ``silu``), while ``recompute=True`` re-runs
the forward's products too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.distributed import (dots_saveable, recompute,
                                          recompute_sequential)
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict, named_grads)
from paddle_tpu_torch.nn import Dropout, Linear

SEQ = 128
MODES = (False, True, "selective")


@pytest.fixture(autouse=True)
def _no_tp():
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(saved)


def _ids(seed=0, b=2, s=SEQ):
    return np.random.RandomState(seed).randint(0, 256, (b, s)) \
        .astype(np.int32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def reference():
    """The reference's selective-recompute model: its weights, logits,
    loss and grads on one batch."""
    paddle.seed(0)
    jm = JModel(dataclasses.replace(JConfig.tiny(), recompute="selective"))
    jm.train()
    ids = _ids()
    logits = jm(Tensor(ids))
    loss = JCrit()(logits, Tensor(ids))
    loss.backward()
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    grads = {n: _np(p.grad._data) for n, p in jm.named_parameters()}
    return state, _np(logits._data), float(loss._data), grads


def _port(state, recompute_mode):
    cfg = dataclasses.replace(LlamaConfig.tiny(), recompute=recompute_mode)
    tm = LlamaForCausalLM(cfg, device="cpu")
    from_jax_state_dict(tm, state)
    return tm


def _run(tm, ids):
    logits = tm(torch.from_numpy(ids))
    loss = LlamaPretrainingCriterion()(logits, torch.from_numpy(ids))
    loss.backward()
    return logits.detach(), float(loss.detach()), named_grads(tm)


@pytest.fixture(scope="module")
def port_runs(reference):
    state = reference[0]
    return {m: _run(_port(state, m), _ids()) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_logits_and_grads_match_reference(reference, port_runs, mode):
    _, jl, jloss, jg = reference
    tl, tloss, tg = port_runs[mode]
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5, rtol=0)
    assert abs(tloss - jloss) < 1e-5
    assert set(tg) == set(jg)
    for n in jg:
        assert _rel(tg[n], jg[n]) <= 1e-4, n


@pytest.mark.parametrize("mode", [True, "selective"])
def test_modes_equal_no_recompute_bit_for_bit(port_runs, mode):
    bl, bloss, bg = port_runs[False]
    tl, tloss, tg = port_runs[mode]
    assert torch.equal(tl, bl) and tloss == bloss
    for n in bg:
        np.testing.assert_array_equal(tg[n], bg[n], err_msg=n)


class _Count(TorchDispatchMode):
    """Counts aten ops by name while active."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops_and_saved(reference, mode):
    """The aten ops the backward runs, and the tensors saved outside any
    checkpoint during the forward."""
    tm = _port(reference[0], mode)
    ids = torch.from_numpy(_ids())
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = LlamaPretrainingCriterion()(tm(ids), ids)
    with _Count() as c:
        loss.backward()
    return c.ops, saved[0]


def test_selective_keeps_the_products_and_recomputes_the_rest(reference):
    plain, saved_plain = _backward_ops_and_saved(reference, False)
    sel, saved_sel = _backward_ops_and_saved(reference, "selective")
    full, saved_full = _backward_ops_and_saved(reference, True)
    # the checkpointed layers save nothing through the outer hooks
    assert saved_sel == saved_full < saved_plain
    # no forward product runs again under selective; all do under full
    # (7 linears a layer, 2 layers; the plain attention's products too)
    assert sel.get("mm", 0) == plain.get("mm", 0)
    assert full.get("mm", 0) >= plain.get("mm", 0) + 14
    # the elementwise forward runs again under both
    for op in ("rsqrt", "silu"):
        assert sel.get(op, 0) > plain.get(op, 0), op
        assert full.get(op, 0) == sel.get(op, 0), op


def test_policy_keeps_exactly_the_products():
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default,
               aten.baddbmm.default):
        assert dots_saveable(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.mul.Tensor, aten.rsqrt.default, aten.silu.default,
               aten.empty.memory_format, aten._softmax.default):
        assert dots_saveable(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


class _Block(torch.nn.Module):
    def __init__(self, gen):
        super().__init__()
        set_device("cpu")
        try:
            self.fc = Linear(8, 8)
            self.drop = Dropout(0.5, generator=gen)
        finally:
            set_device(None)

    def forward(self, x):
        return self.drop(torch.tanh(self.fc(x))) * 2.0


@pytest.mark.parametrize("policy", [None, dots_saveable])
def test_dropout_under_recompute_draws_the_forward_masks(policy):
    """The segment's generator is rewound for the recompute: the grads
    equal a plain run's from the same generator state, and the generator
    ends where the forward left it."""
    gen = torch.Generator().manual_seed(3)
    block = _Block(gen)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8)
                         .astype(np.float32)).requires_grad_()
    state0 = gen.get_state()
    out_plain = block(x)
    out_plain.square().sum().backward()
    want = [x.grad.clone()] + [p.grad.clone() for p in block.parameters()]
    after_plain = gen.get_state()
    x.grad = None
    block.zero_grad()
    gen.set_state(state0)
    out = recompute(block, x, policy=policy)
    after_fwd = gen.get_state()
    out.square().sum().backward()
    got = [x.grad] + [p.grad for p in block.parameters()]
    assert torch.equal(out, out_plain)
    assert torch.equal(after_fwd, after_plain)
    assert torch.equal(gen.get_state(), after_fwd)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_recompute_sequential_chains_segments():
    torch.manual_seed(0)
    fs = [torch.nn.Linear(6, 6), torch.nn.Tanh(), torch.nn.Linear(6, 2)]
    x = torch.randn(3, 6, requires_grad=True)
    want = fs[2](fs[1](fs[0](x)))
    want.sum().backward()
    gw = [x.grad.clone()] + [p.grad.clone() for f in fs
                             for p in f.parameters()]
    x.grad = None
    for f in fs:
        f.zero_grad()
    got = recompute_sequential({}, fs, x)
    got.sum().backward()
    gg = [x.grad] + [p.grad for f in fs for p in f.parameters()]
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(gg, gw))


@pytest.mark.parametrize("mode", MODES)
def test_a_dropped_train_step_frees_its_model_and_optimizer(mode):
    """The capture probe's watches hold no probe (torch caches the
    functions it lists the first time a recompute asks for them): a
    TrainStep dropped after its probe, capture and a replay leaves no
    reference to its model or optimizer."""
    import gc
    import weakref

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    def build():
        tm = LlamaForCausalLM(dataclasses.replace(
            LlamaConfig.tiny(), recompute=mode), device="cpu")
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        train = TrainStep(tm, LlamaPretrainingCriterion(), opt)
        ids = torch.from_numpy(_ids(b=1, s=32))
        for _ in range(3):
            train((ids,), (ids,))
        return [weakref.ref(o) for o in (tm, opt, train)]

    refs = build()
    gc.collect()
    assert all(r() is None for r in refs)
