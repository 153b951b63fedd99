"""The port's Llama training path against the JAX package's, at a tiny size.

The JAX tiny model (``LlamaConfig.tiny()``: hidden 64, 4/2 heads, 2
layers, vocab 256) is built from its own seed and its weights move across
with ``from_jax_state_dict``; both then see the same token ids (numpy,
seeded) at seq 128, where the JAX package's Pallas flash kernel runs (in
interpret mode on the CPU) and the port's flash path takes its plain
version. Held to the reference, float32:

- training-forward logits and ``LlamaPretrainingCriterion`` loss, atol
  1e-5 (the matmuls and attention sum in another order);
- every parameter's grad after ``loss.backward()``, max error relative to
  the tensor's max 1e-4;
- three ``AdamW`` + ``ClipGradByGlobalNorm`` steps: each step's loss atol
  1e-5; then every parameter atol 1e-4 and all but 1 in 10^4 elements
  atol 1e-5 (lr 1e-3: Adam's first steps move each weight by about lr
  whatever the grad's size, so an element whose grad is near zero can
  take another direction from a 1e-4 relative grad difference; measured:
  1 of 106816 elements differs by more than 1e-5, by 5.3e-5);
- a bf16 model with float32 masters: logits atol 5e-2 (about 6 bf16 ulps
  at the logits' scale of 1: bf16 matmuls round in another order),
  losses atol 2e-3, and the masters' three-step updates pointing the
  same way (cosine >= 0.9; elementwise, Adam turns bf16 grad differences
  into sign flips of small updates).

Held within the port: ``TrainStep`` equals the hand-written loop bit for
bit; ``recompute=True`` gives the same grads; the composite attention
(``use_flash_attention=False``) the same logits; the no-cache forward's
logits equal the cache path's prefill logits; entry points raise without
a GPU unless given ``device="cpu"``.
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
from paddle_tpu.ops.kernels.pallas import flash_attention as jfa
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict, named_grads,
                                     named_optimizer_state)
from paddle_tpu_torch.models.generation import PagedKVCache
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

SEQ = 128


@pytest.fixture(autouse=True)
def _no_tp():
    """The single-device path: clear any hybrid group other test files
    left in this worker."""
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(saved)


def _ids(seed=0, b=2, s=SEQ, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype(np.int32)


def _pair(dtype="float32", **port_kw):
    paddle.seed(0)
    jm = JModel(JConfig(**dataclasses.asdict(JConfig.tiny()) | {
        "dtype": dtype}))
    jm.train()
    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=dtype, **port_kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def fwd_bwd():
    """Logits, loss and grads of one batch through both packages."""
    assert jfa.supported((2, SEQ, 4, 16), (2, SEQ, 2, 16), True)
    jm, tm = _pair()
    ids = _ids()
    jl = jm(Tensor(ids))
    jloss = JCrit()(jl, Tensor(ids))
    jloss.backward()
    jg = {n: _np(p.grad._data) for n, p in jm.named_parameters()}
    tl = tm(torch.from_numpy(ids))
    tloss = LlamaPretrainingCriterion()(tl, torch.from_numpy(ids))
    tloss.backward()
    return (_np(jl._data), float(jloss._data), jg,
            tl.detach().numpy(), float(tloss.detach()), named_grads(tm))


def test_logits_and_loss_match(fwd_bwd):
    jl, jloss, _, tl, tloss, _ = fwd_bwd
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert abs(tloss - jloss) < 1e-5


def test_every_grad_matches(fwd_bwd):
    _, _, jg, _, _, tg = fwd_bwd
    assert set(tg) == set(jg)
    for name in jg:
        assert _rel(tg[name], jg[name]) < 1e-4, (name, _rel(tg[name],
                                                            jg[name]))


def test_ignored_labels_count_as_zero_in_the_mean():
    jm, tm = _pair()
    ids = _ids(1)
    labels = ids.copy()
    labels[:, ::3] = -100
    with torch.no_grad():
        t = float(LlamaPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                              torch.from_numpy(labels)))
    j = float(JCrit()(jm(Tensor(ids)), Tensor(labels))._data)
    assert abs(t - j) < 1e-5


def _jax_train(jm, ids, steps):
    opt = JO.AdamW(learning_rate=1e-3, weight_decay=0.01,
                   parameters=jm.parameters(),
                   grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    crit, losses = JCrit(), []
    for _ in range(steps):
        loss = crit(jm(Tensor(ids)), Tensor(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss._data))
    names = [n for n, _ in jm.named_parameters()]
    masters = {n: _np(m) for n, m in zip(names, opt._masters)
               if m is not None}
    return losses, {n: _np(p._data) for n, p in jm.named_parameters()}, \
        masters


def _port_opt(tm):
    return AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))


def test_three_adamw_clip_steps_track_reference():
    jm, tm = _pair()
    ids = _ids(2)
    jlosses, jparams, _ = _jax_train(jm, ids, 3)
    train = TrainStep(tm, LlamaPretrainingCriterion(), _port_opt(tm))
    t_ids = torch.from_numpy(ids)
    tlosses = [float(train((t_ids,), (t_ids,))) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)
    diff = np.concatenate([np.abs(p.detach().numpy() - jparams[n]).ravel()
                           for n, p in tm.named_parameters()])
    assert diff.max() < 1e-4
    assert (diff > 1e-5).mean() < 1e-4


def test_bf16_with_float32_masters_tracks_reference():
    jm, tm = _pair("bfloat16")
    ids = _ids(3)
    with torch.no_grad():
        tl = tm(torch.from_numpy(ids)).float().numpy()
    np.testing.assert_allclose(tl, _np(jm(Tensor(ids))._data), atol=5e-2,
                               rtol=0)
    start = {n: p.detach().float().numpy() for n, p in tm.named_parameters()}
    jlosses, _, jmasters = _jax_train(jm, ids, 3)
    opt = _port_opt(tm)
    train = TrainStep(tm, LlamaPretrainingCriterion(), opt)
    t_ids = torch.from_numpy(ids)
    tlosses = [float(train((t_ids,), (t_ids,))) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, atol=2e-3, rtol=0)
    state = named_optimizer_state(tm, opt)
    assert set(state) == set(jmasters)
    for n, m in jmasters.items():
        a, b = state[n]["master"] - start[n], m - start[n]
        cos = float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))
        assert cos >= 0.9, (n, cos)
    for p in tm.parameters():
        assert p.dtype == torch.bfloat16


def test_train_step_equals_hand_written_loop():
    _, a = _pair()
    _, b = _pair()
    t_ids = torch.from_numpy(_ids(4))
    train = TrainStep(a, LlamaPretrainingCriterion(), _port_opt(a))
    la = [float(train((t_ids,), (t_ids,))) for _ in range(2)]
    opt, crit, lb = _port_opt(b), LlamaPretrainingCriterion(), []
    for _ in range(2):
        loss = crit(b(t_ids), t_ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        lb.append(float(loss.detach()))
    assert la == lb
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("variant", [dict(recompute=True),
                                     dict(use_flash_attention=False)])
def test_recompute_and_composite_give_the_same_grads(fwd_bwd, variant):
    *_, tl_ref, _, tg_ref = fwd_bwd
    _, tm = _pair(**variant)
    ids = torch.from_numpy(_ids())
    logits = tm(ids)
    LlamaPretrainingCriterion()(logits, ids).backward()
    tol = 0 if variant.get("recompute") else 1e-5
    np.testing.assert_allclose(logits.detach().numpy(), tl_ref, atol=tol,
                               rtol=0)
    for n, g in named_grads(tm).items():
        assert _rel(g, tg_ref[n]) <= (0 if tol == 0 else 1e-4), n


def test_unported_layer_options_raise():
    for kw in (dict(recompute="selective"), dict(use_scan_layers=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(), **kw),
                             device="cpu")


def test_no_cache_logits_equal_cache_prefill():
    _, tm = _pair()
    ids = torch.from_numpy(_ids(5, b=1, s=40))
    with torch.no_grad():
        got = tm(ids)
    cfg = tm.config
    cache = PagedKVCache(cfg.num_hidden_layers, 1, num_blocks=4,
                         block_size=16, num_kv_heads=cfg.num_key_value_heads,
                         head_dim=16, max_blocks_per_seq=4, device="cpu")
    want = tm(ids, cache=cache, start_pos=0)
    assert not want.requires_grad   # the cache path builds no graph
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_entry_points_need_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert all(p.requires_grad for p in m.parameters())
