"""One rank of ``tests/test_torch_expert_parallel.py``'s world-4 launch.

Started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 4 --devices cpu tests/_torch_expert_parallel_worker.py
DIR``. It waits for ``DIR/inputs.npz`` (the test writes it after the
launch: seeded numpy inputs and the JAX package's tiny MoE weights), runs
the port's expert parallelism over gloo on the CPU at dp 4 and writes
``DIR/rank<r>.npz`` and ``DIR/rank<r>.json``:

1. ``call_op("moe_ffn", ..., expert_axis="dp")`` on the rank's 4 of 16
   tokens with every expert's weights (each rank runs 2 of the 8), and a
   ``MoELayer`` built holding its 2 experts: outputs, aux, grads;
2. the fallbacks: ranks with 3, 4, 5 and 6 tokens (the cut experts are
   gathered), and 6 experts over 4 ranks (never cut);
3. the tiny MoE model (8 experts, 2 a rank) under ``DataParallel`` with
   expert parallelism: the losses of three AdamW steps with an active
   global-norm clip, the first grads, the parameters after the steps, and
   how often the first forward checked the ranks' token counts.

Only the port is imported here (no JAX).
"""

import json
import os
import sys
import time

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import (from_jax_state_dict, shard_state_dict)
from paddle_tpu_torch.models.moe import (MoEConfig, MoEForCausalLM,
                                         MoEPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.initializer import ParamInit
from paddle_tpu_torch.nn.moe import MoELayer
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops.dispatcher import call_op
from paddle_tpu_torch.ops.kernels import moe as M
from paddle_tpu_torch.optimizer import AdamW

OUT = sys.argv[1]
INPUTS_WAIT_S = 120
torch.set_num_threads(1)
paddle.set_device("cpu")
res, meta = {}, {}
inp = {}


def load_inputs():
    path = os.path.join(OUT, "inputs.npz")
    deadline = time.monotonic() + INPUTS_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {INPUTS_WAIT_S} s")
        time.sleep(0.05)
    inp.update(np.load(path))


def t(name):
    return torch.from_numpy(inp[name]).clone()


def ep_calls(r):
    rows = slice(4 * r, 4 * r + 4)
    x = t("x")[rows].requires_grad_(True)
    ws = [t(n).requires_grad_(True) for n in ("gw", "gp", "up", "dp")]
    calls = metrics.registry().get("moe.ep_calls")
    c0 = calls.value
    out, aux = call_op("moe_ffn", x, *ws, top_k=2, expert_axis="dp")
    (out * t("ct")[rows]).sum().backward()
    meta["ep_calls"] = calls.value - c0
    res.update(op_out=out.detach().numpy(), op_aux=aux.detach().numpy(),
               op_dx=x.grad.numpy())
    for n, w in zip(("gw", "gp", "up", "dp"), ws):
        res[f"op_d{n}"] = w.grad.numpy()

    layer = MoELayer(8, 16, num_experts=8, top_k=2,
                     init=ParamInit.make("cpu"))
    e = layer.experts
    meta["layer_local_experts"] = int(e.gate_weight.shape[0])
    meta["layer_marks"] = [bool(getattr(e.gate_weight, a, False))
                           for a in ("is_expert", "no_sync")]
    with torch.no_grad():
        layer.gate.weight.copy_(t("gw"))
        for mine, n in ((e.gate_weight, "gp"), (e.up_weight, "up"),
                        (e.down_weight, "dp")):
            mine.copy_(t(n)[2 * r:2 * r + 2])
    x = t("x")[rows].reshape(1, 4, 8).requires_grad_(True)
    y = layer(x)
    (y * t("ct")[rows].reshape(1, 4, 8)).sum().backward()
    res.update(layer_out=y.detach().numpy(), layer_dx=x.grad.numpy())
    for mine, n in ((e.gate_weight, "gp"), (e.up_weight, "up"),
                    (e.down_weight, "dp")):
        res[f"layer_d{n}"] = mine.grad.numpy()


def fallbacks(r):
    fb = metrics.registry().get("moe.ep_fallback")
    n = 3 + r
    x = t("x")[:n].reshape(1, n, 8)
    layer = MoELayer(8, 16, num_experts=8, top_k=2,
                     init=ParamInit.make("cpu"))
    e = layer.experts
    with torch.no_grad():
        layer.gate.weight.copy_(t("gw"))
        for mine, name in ((e.gate_weight, "gp"), (e.up_weight, "up"),
                           (e.down_weight, "dp")):
            mine.copy_(t(name)[2 * r:2 * r + 2])
    c0 = fb.value
    y = layer(x.requires_grad_(True))
    y.sum().backward()
    meta["ragged_fallbacks"] = fb.value - c0
    res["ragged_out"] = y.detach().numpy()
    res["ragged_dgp"] = e.gate_weight.grad.numpy()
    layer6 = MoELayer(8, 16, num_experts=6, top_k=2,
                      init=ParamInit.make("cpu"))
    meta["e6_local_experts"] = int(layer6.experts.gate_weight.shape[0])
    e = layer6.experts
    with torch.no_grad():
        layer6.gate.weight.copy_(t("gw6"))
        for mine, name in ((e.gate_weight, "gp6"), (e.up_weight, "up6"),
                           (e.down_weight, "dp6")):
            mine.copy_(t(name))
    c0 = fb.value
    with torch.no_grad():
        res["e6_out"] = layer6(t("x")[4 * r:4 * r + 4].reshape(1, 4, 8)
                               ).numpy()
    meta["e6_fallbacks"] = fb.value - c0


def moe_model(hcg):
    cfg = MoEConfig.tiny_moe(num_experts=8)
    model = MoEForCausalLM(cfg, device="cpu")
    state = {k[4:]: v for k, v in inp.items() if k.startswith("moe/")}
    from_jax_state_dict(model, shard_state_dict(model, state, hcg))
    net = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(float(inp["clip"]))))
    meta["clip"] = type(opt._grad_clip).__name__
    dp = hcg.get_data_parallel_group()
    ids = t("ids")[dp.rank:dp.rank + 1].long()
    crit = MoEPretrainingCriterion(cfg, model)
    losses = []
    checks = []
    real = M._tokens_reason

    def counted(*args):
        checks.append(1)
        return real(*args)
    for step in range(3):
        M._tokens_reason = counted
        try:
            loss = crit(net(ids), ids)
        finally:
            M._tokens_reason = real
        if step == 0:
            meta["token_checks_first_forward"] = len(checks)
            meta["moe_layers"] = sum(
                isinstance(m, MoELayer) for m in model.modules())
        loss.backward()
        if step == 0:
            for name, p in model.named_parameters():
                res[f"grad/{name}"] = p.grad.numpy().copy()
        opt.step()
        opt.clear_grad()
        avg = loss.detach().reshape(1).clone()
        C.all_reduce(avg, op=C.ReduceOp.AVG, group=dp)
        losses.append(float(avg))
    for name, p in model.named_parameters():
        res[f"param/{name}"] = p.detach().numpy().copy()
    meta["moe_losses"] = losses


def main():
    C.init_parallel_env(backend="gloo")
    r = C.get_rank()
    load_inputs()
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 4}
    hcg = fleet.init(is_collective=True, strategy=s, backend="gloo")
    ep_calls(r)
    fallbacks(r)
    moe_model(hcg)
    np.savez(os.path.join(OUT, f"rank{r}.npz"), **res)
    with open(os.path.join(OUT, f"rank{r}.json"), "w") as f:
        json.dump(meta, f)
    C.barrier()
    C.destroy_process_group()


if __name__ == "__main__":
    main()
