"""The port's MoE path against the JAX package's, at a tiny size.

Inputs and weights are made from seeds with numpy (or by the JAX model,
whose weights move across with ``from_jax_state_dict``); the JAX side runs
its grouped GEMM and flash kernels in Pallas interpret mode on the CPU,
the port its plain versions. Held to the reference, float32:

- ``route_topk``: ``idx`` and ``counts`` equal (asserted before anything
  is compared numerically, so a tie that topk orders otherwise fails
  loudly), combine weights and the aux loss within 1e-6;
- ``_moe_local`` and ``MoELayer`` outputs within 1e-5, the layer's aux
  loss and grads too; the dense ``TopKGate`` forward within 1e-5;
- ``MoEConfig.tiny_moe(first_k_dense_replace=1)`` (a dense layer, then an
  MoE layer with a shared expert): logits and the loss with its aux term
  within 1e-5, every grad name for name within 1e-5 abs + 1e-4 rel, and
  three ``AdamW`` + ``ClipGradByGlobalNorm`` steps whose losses track the
  reference's within 1e-5;
- ``from_jax_state_dict`` takes every MoE name (router, stacked experts,
  shared expert, per-layer rotary buffers).
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
from paddle_tpu.models.moe import MoEConfig as JConfig
from paddle_tpu.models.moe import MoEForCausalLM as JModel
from paddle_tpu.models.moe import MoEPretrainingCriterion as JCrit
from paddle_tpu.nn.moe import MoELayer as JMoELayer
from paddle_tpu.nn.moe import TopKGate as JTopKGate
from paddle_tpu.ops.kernels import moe as jmoe
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (MoEConfig, MoEForCausalLM,
                                     MoEPretrainingCriterion,
                                     from_jax_state_dict, named_grads)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, MoELayer, ParamInit, \
    TopKGate
from paddle_tpu_torch.ops.kernels import moe as tmoe
from paddle_tpu_torch.optimizer import AdamW

SEQ = 128


@pytest.fixture(autouse=True)
def _no_tp():
    """The single-shard path: clear any hybrid group other test files
    left in this worker."""
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(saved)


def _rand(*shape, seed=0, scale=0.1):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _cpu_init():
    return ParamInit.make("cpu")


def _weights(t, h, m, E, seed=0):
    return (_rand(t, h, seed=seed, scale=1.0),
            _rand(h, E, seed=seed + 1, scale=1.0),
            _rand(E, h, m, seed=seed + 2), _rand(E, h, m, seed=seed + 3),
            _rand(E, m, h, seed=seed + 4))


# -- routing -----------------------------------------------------------------

ROUTES = {  # t, h, E, top_k, capacity_factor
    "top2": (48, 16, 4, 2, 1.25),
    "top6_of_16_tight": (64, 16, 16, 6, 0.5),    # many drops
    "top1": (40, 8, 8, 1, 2.0),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_topk_matches_reference(case):
    t, h, E, k, cf = ROUTES[case]
    x, gw = _rand(t, h, seed=3, scale=1.0), _rand(h, E, seed=4, scale=1.0)
    C = tmoe.moe_capacity(t, k, E, cf)
    assert C == jmoe.moe_capacity(t, k, E, cf)
    ji, jw, jc, ja = jmoe.route_topk(jnp.asarray(x), jnp.asarray(gw), k, C)
    ti, tw, tc, ta = tmoe.route_topk(torch.from_numpy(x),
                                     torch.from_numpy(gw), k, C)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ti.dtype == tc.dtype == torch.int32
    np.testing.assert_allclose(tw.numpy(), _np(jw), atol=1e-6, rtol=0)
    assert abs(float(ta) - float(ja)) < 1e-6
    if case == "top6_of_16_tight":
        assert int(tc.sum()) < t * k, "the case must drop tokens"


@pytest.mark.parametrize("use_pallas", [None, False])
def test_moe_local_matches_reference(use_pallas):
    t, h, m, E, k = 24, 8, 16, 4, 2
    args = _weights(t, h, m, E, seed=5)
    jo, ja = jmoe._moe_local(*map(jnp.asarray, args), k, 1.25, True)
    to, ta = tmoe._moe_local(*map(torch.from_numpy, args), k, 1.25,
                             use_pallas)
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5, rtol=0)
    assert abs(float(ta) - float(ja)) < 1e-6


def _layer_pair(h=8, m=16, E=4, k=2, seed=0):
    paddle.seed(seed)
    jl = JMoELayer(h, m, num_experts=E, top_k=k)
    tl = MoELayer(h, m, E, top_k=k, init=_cpu_init())
    from_jax_state_dict(tl, {n: np.asarray(v._data)
                             for n, v in jl.state_dict().items()})
    return jl, tl


def test_moe_layer_output_aux_and_grads_match():
    jl, tl = _layer_pair()
    x = _rand(2, 6, 8, seed=7, scale=1.0)
    jx = Tensor(x)
    jx.stop_gradient = False
    jo = jl(jx)
    ((jo * jo).sum() + jl.aux_loss).backward()
    tx = torch.from_numpy(x).requires_grad_()
    to = tl(tx)
    ((to * to).sum() + tl.aux_loss).backward()
    np.testing.assert_allclose(to.detach().numpy(), _np(jo._data),
                               atol=1e-5, rtol=0)
    assert abs(float(tl.aux_loss.detach()) - float(jl.aux_loss._data)) < 1e-6
    jg = {n: _np(p.grad._data) for n, p in jl.named_parameters()}
    tg = named_grads(tl)
    assert set(tg) == set(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], atol=1e-5, rtol=1e-4,
                                   err_msg=n)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad._data),
                               atol=1e-5, rtol=1e-4)


def test_dense_gate_matches_reference():
    paddle.seed(1)
    jg = JTopKGate(8, 4, top_k=2)
    tg = TopKGate(8, 4, top_k=2, init=_cpu_init())
    from_jax_state_dict(tg, {"weight": np.asarray(jg.weight._data)})
    x = _rand(16, 8, seed=3, scale=1.0)
    jc, jd, ja = jg(Tensor(x))
    tc, td, ta = tg(torch.from_numpy(x))
    assert tg.capacity(16) == jg.capacity(16)
    np.testing.assert_allclose(tc.detach().numpy(), _np(jc._data),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(td.numpy(), _np(jd._data))
    assert abs(float(ta.detach()) - float(ja._data)) < 1e-6


def test_expert_ffn_counts_none_is_a_dense_grouped_ffn():
    _, tl = _layer_pair(seed=2)
    ex = tl.experts
    x = torch.from_numpy(_rand(4, 5, 8, seed=8, scale=1.0))
    g = torch.einsum("eck,ekn->ecn", x, ex.gate_weight)
    u = torch.einsum("eck,ekn->ecn", x, ex.up_weight)
    want = torch.einsum("eck,ekn->ecn", torch.nn.functional.silu(g) * u,
                        ex.down_weight)
    np.testing.assert_allclose(ex(x).detach().numpy(),
                               want.detach().numpy(), atol=1e-5, rtol=0)


# -- the model ---------------------------------------------------------------

def _ids(seed=0, b=2, s=SEQ, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype(np.int32)


def _pair(dtype="float32"):
    kw = dict(first_k_dense_replace=1, dtype=dtype)
    paddle.seed(0)
    jm = JModel(JConfig.tiny_moe(**kw))
    jm.train()
    tm = MoEForCausalLM(MoEConfig.tiny_moe(**kw), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def test_state_dict_names_and_values_carry_over():
    jm, tm = _pair()
    js = jm.state_dict()
    ts = tm.state_dict()
    assert set(ts) == set(js)
    for name in ("model.layers.1.mlp.moe.gate.weight",
                 "model.layers.1.mlp.moe.experts.gate_weight",
                 "model.layers.1.mlp.moe.experts.up_weight",
                 "model.layers.1.mlp.moe.experts.down_weight",
                 "model.layers.1.mlp.shared.gate_proj.weight",
                 "model.layers.1.mlp.shared.down_proj.weight",
                 "model.layers.0.mlp.gate_proj.weight",
                 "model.layers.1.self_attn.rotary.cos_cached",
                 "lm_head.weight"):
        np.testing.assert_array_equal(ts[name].numpy(),
                                      np.asarray(js[name]._data))
    assert tuple(ts["model.layers.1.mlp.moe.experts.down_weight"].shape) \
        == (4, 32, 64)
    _, bm = _pair("bfloat16")
    assert bm.model.layers[1].mlp.moe.experts.up_weight.dtype == \
        torch.bfloat16


@pytest.fixture(scope="module")
def fwd_bwd():
    jm, tm = _pair()
    ids = _ids()
    jl = jm(Tensor(ids))
    jloss = JCrit(jm.config, jm)(jl, Tensor(ids))
    jloss.backward()
    jg = {n: _np(p.grad._data) for n, p in jm.named_parameters()}
    tl = tm(torch.from_numpy(ids))
    tloss = MoEPretrainingCriterion(tm.config, tm)(tl, torch.from_numpy(ids))
    tloss.backward()
    return (_np(jl._data), float(jloss._data), jg, tl.detach().numpy(),
            float(tloss.detach()), named_grads(tm),
            float(jm.model.collect_aux_loss()._data),
            float(tm.model.collect_aux_loss()))


def test_logits_and_loss_with_aux_match(fwd_bwd):
    jl, jloss, _, tl, tloss, _, jaux, taux = fwd_bwd
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert abs(tloss - jloss) < 1e-5
    assert abs(taux - jaux) < 1e-6 and taux > 0


def test_every_grad_matches(fwd_bwd):
    _, _, jg, _, _, tg, _, _ = fwd_bwd
    assert set(tg) == set(jg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_three_adamw_clip_steps_track_reference():
    jm, tm = _pair()
    ids = _ids(2)
    opt = JO.AdamW(learning_rate=1e-3, weight_decay=0.01,
                   parameters=jm.parameters(),
                   grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    crit, jlosses = JCrit(jm.config, jm), []
    for _ in range(3):
        loss = crit(jm(Tensor(ids)), Tensor(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        jlosses.append(float(loss._data))
    train = TrainStep(tm, MoEPretrainingCriterion(tm.config, tm),
                      AdamW(learning_rate=1e-3, weight_decay=0.01,
                            parameters=tm.parameters(),
                            grad_clip=ClipGradByGlobalNorm(1.0)))
    t_ids = torch.from_numpy(ids)
    tlosses = [float(train((t_ids,), (t_ids,))) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)
    assert tlosses[-1] < tlosses[0]


def test_entry_point_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoEForCausalLM(MoEConfig.tiny_moe())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoELayer(8, 16, 4)
    cfg = dataclasses.replace(MoEConfig.tiny_moe(), num_shared_experts=0)
    m = MoEForCausalLM(cfg, device="cpu")
    assert m.model.layers[0].mlp.shared is None
    assert all(p.requires_grad for p in m.parameters())
