"""One rank of ``tests/test_torch_pipeline.py``'s world-4 launch.

Started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 4 --devices cpu tests/_torch_pipeline_worker.py DIR``.
It waits for ``DIR/inputs.npz`` (the test writes it after the launch: the
JAX package's stacked tiny Llama weights and seeded numpy inputs), runs
the port's pipeline over gloo on the CPU and writes ``DIR/rank<r>.npz``
and ``DIR/rank<r>.json``:

1. the tiny Llama built under pp > 1 (its stage's rows, the embedding on
   stage 0, the norm and head on the last), through
   ``fleet.distributed_model`` (``PipelineParallel``) for each case of
   ``CASES``: the loss and grads of one ``forward_backward_pipeline``;
   for ``pp4_1f1b`` also two ``train_batch`` steps of AdamW with an active
   global-norm clip; the time blocked in receives;
2. a ``PipelineLayer`` of linears at pp 4 with a ``SharedLayerDesc`` on
   the first and the last stage: loss and grads, then two SGD
   ``train_batch`` steps.

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
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     from_jax_state_dict, shard_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, AdamW

INPUTS_WAIT_S = 120
res, meta = {}, {}
inp = {}

# name: (pp, virtual stages, microbatches, schedule, layers)
CASES = {"pp2_1f1b": (2, 1, 2, "1F1B", 4),
         "pp2_fthenb": (2, 1, 2, "FThenB", 4),
         "pp4_1f1b": (4, 1, 4, "1F1B", 4),
         "pp2_vpp": (2, 2, 2, "1F1B", 4),
         "pp4_vpp": (4, 2, 4, "1F1B", 8)}


def load_inputs(out):
    path = os.path.join(out, "inputs.npz")
    deadline = time.monotonic() + INPUTS_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {INPUTS_WAIT_S} s")
        time.sleep(0.05)
    inp.update(np.load(path))


def t(name):
    return torch.from_numpy(inp[name]).clone()


def init(pp, v, M, kind):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": pp}
    s.pipeline_configs = {"accumulate_steps": M, "schedule_mode": kind,
                          "virtual_pp_degree": v}
    return fleet.init(is_collective=True, strategy=s, backend="gloo")


def llama_case(name, pp, v, M, kind, layers):
    hcg = init(pp, v, M, kind)
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=layers, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
    model = LlamaForCausalLM(cfg, device="cpu")
    pre = f"L{layers}/"
    state = {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}
    from_jax_state_dict(model, shard_state_dict(model, state, hcg))
    net = fleet.distributed_model(model)
    dp = hcg.get_data_parallel_group()
    rows = inp["ids"].shape[0] // dp.nranks
    ids = t("ids")[dp.rank * rows:(dp.rank + 1) * rows].long()
    loss = net.forward_backward_pipeline((ids, ids))
    info = {"loss": float(loss), "stage": hcg.get_stage_id(),
            "dp_rank": dp.rank, "wrapper": type(net).__name__,
            "reducer": type(net._layers).__name__,
            "rows": model.pipeline_rows,
            "names": sorted(n for n, _ in model.named_parameters()),
            "recv_wait_s": net.stats["recv_wait_s"],
            "busy_s": net.stats["busy_s"]}
    for n, p in model.named_parameters():
        res[f"{name}/grad/{n}"] = p.grad.numpy().copy()
    if name == "pp4_1f1b":
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(float(inp["clip"]))))
        opt.clear_grad()
        info["clip"] = type(opt._grad_clip).__name__
        info["steps"] = [float(net.train_batch((ids, ids), opt))
                         for _ in range(2)]
        for n, p in model.named_parameters():
            res[f"{name}/param/{n}"] = p.detach().numpy().copy()
    meta[name] = info


class Lin(torch.nn.Module):
    """x @ W + b, Paddle's [in, out] layout."""

    def __init__(self, i, o):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(i, o))
        self.bias = torch.nn.Parameter(torch.zeros(o))

    def forward(self, x):
        return x @ self.weight + self.bias


class Tie(torch.nn.Module):
    """x @ W, the weight shared by the first and the last position."""

    def __init__(self, i, o):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(i, o))

    def forward(self, x):
        return torch.tanh(x @ self.weight)


def pipeline_layer():
    hcg = init(4, 1, 4, "1F1B")
    descs = [fleet.SharedLayerDesc("tie", Tie, None, "weight", 8, 8)] + \
        [fleet.LayerDesc(Lin, 8, 8) for _ in range(4)] + \
        [fleet.SharedLayerDesc("tie", Tie, None, "weight", 8, 8)]
    stage = hcg.get_stage_id()
    torch.manual_seed(stage)         # the stages' own draws, overwritten
    model = fleet.PipelineLayer(
        descs, loss_fn=lambda out, lbl: ((out - lbl) ** 2).mean())
    calls = list(model.chunks[0])
    run = calls[1] if stage == 0 else calls[0]
    with torch.no_grad():
        run.layer.weight.copy_(t("pl_w")[stage])
        run.layer.bias.copy_(t("pl_b")[stage])
        if stage == 0:              # stage 3's copy came by the broadcast
            calls[0].layer.weight.copy_(t("pl_tie_w"))
    for w, group in model._shared.values():
        with torch.no_grad():       # again, now that stage 0 holds it
            C.broadcast(w.data, src=group.ranks[0], group=group)
    net = fleet.distributed_model(model)
    x, y = t("pl_x"), t("pl_y")
    loss = net.forward_backward_pipeline((x, y))
    info = {"loss": float(loss), "stage": stage, "n_calls": len(calls),
            "shared_copy": [bool(getattr(c.layer.weight,
                                         "pipeline_shared_copy", False))
                            for c in calls]}
    for j, c in enumerate(calls):
        for n, p in c.layer.named_parameters():
            res[f"pl/grad/{j}/{n}"] = p.grad.numpy().copy()
    opt = SGD(learning_rate=0.1, parameters=model.parameters())
    opt.clear_grad()
    info["steps"] = [float(net.train_batch((x, y), opt)) for _ in range(2)]
    info["eval"] = float(net.eval_batch((x, y)))
    meta["pl"] = info


def main(out):
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    C.init_parallel_env(backend="gloo")
    r = C.get_rank()
    load_inputs(out)
    for name, case in CASES.items():
        llama_case(name, *case)
    pipeline_layer()
    np.savez(os.path.join(out, f"rank{r}.npz"), **res)
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(meta, f)
    C.barrier()
    C.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
