"""``nn.LayerStack`` and ``LlamaConfig(use_scan_layers=True)`` against the
JAX package's, at a tiny size.

The reference's tiny Llama (hidden 64, 4/2 heads, 2 layers, vocab 256)
is built with ``use_scan_layers=True`` from its seed; its ``state_dict``
(``llama.layer_stack.stacked_{j}``) loads into the port's scan model
through ``from_jax_state_dict``, and both see the same token ids (numpy,
seeded) at seq 64. Held to the reference, float32: the logits and loss
atol 1e-5, each stacked grad within 1e-4 of the tensor's max
(``test_torch_llama_training.py``'s limits). The ``state_dict`` names are
the reference's, and the selective-recompute scan model gives the same
grads.

Held within the port:

- one seed gives the scan build the list build's weights bit for bit
  (layer i's rows are drawn in layer i's order), and so the same step-1
  logits, loss and grads (a layer's grad is its stacked grad's row);
- a captured ``TrainStep`` (the CPU stand-in) trains the scan build for
  four AdamW steps with the global-norm clip: bit for bit the eager loop
  of the scan build, and the list build's step-1 loss bit for bit; later
  losses within 1e-6 and weights within 1e-6 of the list build's (the
  clip's global norm sums per-tensor norms, and stacking changes that
  float order); in bf16 the later losses within 2e-3 (the bf16 loss
  limit of ``test_torch_llama_training.py``);
- the template holds no parameter storage (meta) and is no submodule;
  ``train()`` / ``eval()`` reach it; the stacked layout's KV-cache decode
  raises, as the reference's does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit import step_capture as sc
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict)
from paddle_tpu_torch.models.generation import PagedKVCache
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, LayerStack
from paddle_tpu_torch.optimizer import AdamW

SEQ = 64
BF16_LOSS_ATOL = 2e-3     # test_torch_llama_training.py's bf16 loss limit


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


def _model(**kw):
    return LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny(), **kw),
                            device="cpu",
                            generator=torch.Generator().manual_seed(5))


@pytest.fixture(scope="module")
def reference():
    paddle.seed(0)
    jm = JModel(dataclasses.replace(JConfig.tiny(), use_scan_layers=True))
    jm.train()
    ids = _ids()
    logits = jm(Tensor(ids))
    loss = JCrit()(logits, Tensor(ids))
    loss.backward()
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    grads = {n: _np(p.grad._data) for n, p in jm.named_parameters()}
    return state, _np(logits._data), float(loss._data), grads


def _fwd_bwd(tm, ids):
    logits = tm(torch.from_numpy(ids))
    loss = LlamaPretrainingCriterion()(logits, torch.from_numpy(ids))
    loss.backward()
    return logits.detach(), loss.detach()


@pytest.mark.parametrize("recompute", [False, "selective"])
def test_scan_model_matches_reference(reference, recompute):
    state, jl, jloss, jg = reference
    tm = _model(use_scan_layers=True, recompute=recompute)
    assert sorted(tm.state_dict()) == sorted(state)
    from_jax_state_dict(tm, state)
    tl, tloss = _fwd_bwd(tm, _ids())
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-5, rtol=0)
    assert abs(float(tloss) - jloss) < 1e-5
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(got) == set(jg)
    for n in jg:
        assert got[n].shape == jg[n].shape
        assert _rel(got[n], jg[n]) <= 1e-4, n


def test_one_seed_gives_both_layouts_the_same_weights_and_grads():
    lm, sm = _model(), _model(use_scan_layers=True)
    stack = sm.llama.layer_stack
    names = stack._names
    for i, layer in enumerate(lm.llama.layers):
        own = dict(layer.named_parameters())
        for j, n in enumerate(names):
            assert torch.equal(stack.stacked_params()[j][i], own[n]), (i, n)
    for n in ("llama.embed_tokens.weight", "llama.norm.weight",
              "lm_head.weight"):
        assert torch.equal(lm.state_dict()[n], sm.state_dict()[n])
    ids = _ids(1)
    ll, lloss = _fwd_bwd(lm, ids)
    sl, sloss = _fwd_bwd(sm, ids)
    assert torch.equal(ll, sl) and torch.equal(lloss, sloss)
    for i, layer in enumerate(lm.llama.layers):
        own = dict(layer.named_parameters())
        for j, n in enumerate(names):
            assert torch.equal(stack.stacked_params()[j].grad[i],
                               own[n].grad), (i, n)


def _train(tm, steps, capture):
    tflags.set_flags({"step_capture": capture})
    try:
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=tm.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        train = TrainStep(tm, LlamaPretrainingCriterion(), opt)
        ids = torch.from_numpy(_ids(2))
        losses = [train((ids,), (ids,)) for _ in range(steps)]
    finally:
        tflags.set_flags({"step_capture": True})
    return losses, dict(tm.state_dict())


def test_captured_train_step_trains_the_scan_build():
    before = sc.capture_counters["captures"]
    lc, wc = _train(_model(use_scan_layers=True), 4, True)
    assert sc.capture_counters["captures"] - before == 1
    le, we = _train(_model(use_scan_layers=True), 4, False)
    assert all(torch.equal(a, b) for a, b in zip(lc, le))
    assert all(torch.equal(wc[k], we[k]) for k in we)
    ll, wl = _train(_model(), 4, False)
    assert torch.equal(lc[0], ll[0])
    for a, b in zip(lc[1:], ll[1:]):
        assert abs(float(a) - float(b)) <= 1e-6
    stack = [k for k in wc if "layer_stack" in k]
    names = _model(use_scan_layers=True).llama.layer_stack._names
    for j, k in enumerate(sorted(stack, key=lambda s: int(s.rsplit("_")[-1]))):
        for i in range(2):
            want = wl[f"llama.layers.{i}.{names[j]}"]
            np.testing.assert_allclose(wc[k][i].numpy(), want.numpy(),
                                       atol=1e-6, rtol=0)


def test_bf16_scan_build_tracks_the_list_build():
    """bf16 with float32 masters: step 1's loss bit for bit; after the
    first clip the stacked norm order moves an ulp of the clip
    coefficient, which a bf16 rounding can turn into an ulp of a weight:
    later losses within BF16_LOSS_ATOL of the list build's (the limit
    ``chip_smoke.py``'s ``train_layers`` holds the 8-layer card build
    to)."""
    lc, _ = _train(_model(use_scan_layers=True, dtype="bfloat16"), 4, True)
    ll, _ = _train(_model(dtype="bfloat16"), 4, False)
    assert torch.equal(lc[0], ll[0])
    for a, b in zip(lc[1:], ll[1:]):
        assert abs(float(a) - float(b)) <= BF16_LOSS_ATOL


def test_template_is_structure_only():
    sm = _model(use_scan_layers=True)
    stack = sm.llama.layer_stack
    assert all(p.device.type == "meta"
               for p in stack.template.parameters())
    assert not any(m is stack.template for m in sm.modules())
    assert len(stack.stacked_params()) == len(stack._names) == 9
    assert all(p.shape[0] == 2 for p in stack.stacked_params())
    sm.eval()
    assert not stack.template.training
    assert not stack.template.self_attn.training
    sm.train()
    assert stack.template.mlp.training


def test_stack_of_plain_blocks_runs_each_row():
    torch.manual_seed(0)
    blocks = []

    def block():
        b = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Tanh())
        blocks.append([p.detach().clone() for p in b.parameters()])
        return b

    stack = LayerStack(block, 3)
    x = torch.randn(2, 4)
    want = x
    for w, b in blocks:
        want = torch.tanh(want @ w.T + b)
    torch.testing.assert_close(stack(x), want, rtol=0, atol=0)
    assert [n for n, _ in stack.named_parameters()] == ["stacked_0",
                                                        "stacked_1"]


def test_a_dtype_move_reaches_the_template_buffers():
    class Scaled(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(4, 4)
            self.register_buffer("scale", torch.full((4,), 0.5))

        def forward(self, x):
            return self.fc(x) * self.scale

    stack = LayerStack(Scaled, 2).double()
    assert stack.template.scale.dtype == torch.float64
    assert all(p.dtype == torch.float64 for p in stack.parameters())
    assert stack(torch.ones(3, 4, dtype=torch.float64)).dtype == \
        torch.float64


def test_stacked_layout_kv_cache_decode_raises():
    sm = _model(use_scan_layers=True)
    cfg = sm.config
    cache = PagedKVCache(cfg.num_hidden_layers, 1, num_blocks=4,
                         block_size=16, num_kv_heads=cfg.num_key_value_heads,
                         head_dim=16, max_blocks_per_seq=4, device="cpu")
    with pytest.raises(NotImplementedError, match="KV-cache decode"):
        sm(torch.from_numpy(_ids(3, b=1, s=8)), cache=cache, start_pos=0)
    paddle.seed(0)
    jm = JModel(dataclasses.replace(JConfig.tiny(), use_scan_layers=True))
    with pytest.raises(NotImplementedError, match="KV-cache decode"):
        jm.llama(Tensor(_ids(3, b=1, s=8)), cache=object(), start_pos=0)
