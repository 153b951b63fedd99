"""One rank of ``tests/test_torch_sequence_parallel.py``'s world-4 launch.

Started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 4 --devices cpu tests/_torch_sequence_parallel_worker.py
DIR``. It waits for ``DIR/inputs.npz`` (the test writes it after the
launch: seeded numpy inputs and the JAX package's tiny Llama weights),
runs the port's parts over gloo on the CPU and writes ``DIR/rank<r>.npz``
and ``DIR/rank<r>.json``:

1. dp 2 x mp 2: the four sequence-parallel ops and the two
   sequence-parallel linears (outputs, input and weight grads; the row
   linear's bias grad through ``register_sequence_parallel_allreduce_hooks``);
2. sep 4: ring attention, causal and not (output, q/k/v grads);
3. dp 2 x sep 2: ring attention again; the tiny Llama under
   ``SegmentParallel`` (first loss, grads, two clipped AdamW steps);
4. sep 2 x mp 2: ring attention on the rank's heads, and on every head of
   a config whose heads do not cut (``ring_head_replicated``).

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
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.ops.dispatcher import call_op
from paddle_tpu_torch.ops.kernels import tp_attention
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


def t(name, grad=False):
    x = torch.from_numpy(inp[name]).clone()
    return x.requires_grad_(True) if grad else x


def init(**degrees):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    return fleet.init(is_collective=True, strategy=s, backend="gloo")


def chunk(x, dim, rank, parts):
    n = x.shape[dim] // parts
    return x.narrow(dim, rank * n, n)


def sp_ops(hcg):
    """The ops and linears over the mp group, dp replicas alike."""
    g = hcg.get_model_parallel_group()
    r, n = g.rank, g.nranks
    x_full, ct = t("sp_x"), t("sp_ct")
    x = x_full.clone().requires_grad_(True)
    y = fleet.ScatterOp.apply(x)
    (y * chunk(ct, 1, r, n)).sum().backward()
    res.update(scatter_y=y.detach().numpy(), scatter_dx=x.grad.numpy())
    for name, op in (("gather", fleet.GatherOp), ("allgather",
                                                  fleet.AllGatherOp)):
        x = chunk(x_full, 1, r, n).clone().requires_grad_(True)
        y = op.apply(x)
        (y * ct).sum().backward()
        res.update({f"{name}_y": y.detach().numpy(),
                    f"{name}_dx": x.grad.numpy()})
    x = (x_full / n).requires_grad_(True)          # partials summing to x
    y = fleet.ReduceScatterOp.apply(x)
    (y * chunk(ct, 1, r, n)).sum().backward()
    res.update(rs_y=y.detach().numpy(), rs_dx=x.grad.numpy())

    col = fleet.ColumnSequenceParallelLinear(8, 16, has_bias=True)
    with torch.no_grad():
        col.weight.copy_(chunk(t("col_w"), 1, r, n))
        col.bias.copy_(chunk(t("col_b"), 0, r, n))
    x = chunk(x_full, 1, r, n).clone().requires_grad_(True)
    y = col(x)
    (y * chunk(t("col_ct"), 2, r, n)).sum().backward()
    res.update(col_y=y.detach().numpy(), col_dx=x.grad.numpy(),
               col_dw=col.weight.grad.numpy(), col_db=col.bias.grad.numpy())

    row = fleet.RowSequenceParallelLinear(16, 8, has_bias=True)
    box = torch.nn.Module()
    box.row = row
    fleet.register_sequence_parallel_allreduce_hooks(box)
    with torch.no_grad():
        row.weight.copy_(chunk(t("row_w"), 0, r, n))
        row.bias.copy_(t("row_b"))
    h = chunk(t("row_h"), 2, r, n).clone().requires_grad_(True)
    y = row(h)
    (y * chunk(t("row_ct"), 1, r, n)).sum().backward()
    res.update(row_y=y.detach().numpy(), row_dh=h.grad.numpy(),
               row_dw=row.weight.grad.numpy(), row_db=row.bias.grad.numpy())
    meta["sp_bias_marked"] = bool(getattr(row.bias, "sequence_parallel",
                                          False))


def ring(hcg, tag, heads=None, replicated=False):
    """The ring over the sep group on this rank's sequence chunk (and its
    mp heads unless ``replicated``), output and q/k/v grads."""
    sep, mp = hcg.get_sep_parallel_group(), hcg.get_model_parallel_group()
    pre = "ring" if heads is None else "ringr"
    for causal in (False, True):
        qkv = []
        for name in ("q", "k", "v", "ct"):
            x = chunk(t(f"{pre}_{name}"), 1, sep.rank, sep.nranks)
            if mp.nranks > 1 and not replicated:
                x = chunk(x, 2, mp.rank, mp.nranks)
            qkv.append(x.clone().requires_grad_(name != "ct"))
        q, k, v, ct = qkv
        if replicated:
            with tp_attention.head_replicated():
                out = call_op("ring_attention", q, k, v, is_causal=causal)
        else:
            out = call_op("ring_attention", q, k, v, is_causal=causal)
        (out * ct).sum().backward()
        key = f"{tag}_{'causal' if causal else 'full'}"
        res.update({f"{key}_out": out.detach().numpy(),
                    f"{key}_dq": q.grad.numpy(), f"{key}_dk": k.grad.numpy(),
                    f"{key}_dv": v.grad.numpy()})


def llama_sep(hcg):
    cfg = LlamaConfig.tiny()
    state = {k[6:]: v for k, v in inp.items() if k.startswith("llama/")}
    model = LlamaForCausalLM(cfg, device="cpu")
    from_jax_state_dict(model, state)
    net = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(float(inp["clip"]))))
    dp = hcg.get_data_parallel_group()
    rows = inp["ids"].shape[0] // dp.nranks
    ids = t("ids")[dp.rank * rows:(dp.rank + 1) * rows].long()
    crit = LlamaPretrainingCriterion(cfg)
    losses = []
    for step in range(3):
        loss = crit(net(ids), ids)
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
    meta["llama_losses"] = losses
    meta["sep_wrapper"] = type(net).__name__


def main():
    C.init_parallel_env(backend="gloo")
    rank = C.get_rank()
    load_inputs()
    hcg = init(dp=2, mp=2)
    sp_ops(hcg)
    hcg = init(sep=4)
    meta["sep4"] = [hcg.get_sep_parallel_world_size(),
                    hcg.get_sep_parallel_rank()]
    ring(hcg, "sep4")
    hcg = init(sep=2)
    meta["sep2"] = [hcg.get_data_parallel_world_size(),
                    hcg.get_sep_parallel_rank()]
    ring(hcg, "sep2")
    llama_sep(hcg)
    hcg = init(sep=2, mp=2)
    before = tp_attention.counters()
    ring(hcg, "sepmp")
    meta["sepmp_counters"] = {k: tp_attention.counters()[k] - before[k]
                              for k in before}
    flight_recorder.recorder().clear()
    ring(hcg, "sepmp_rep", heads="r", replicated=True)
    meta["replicated_keys"] = sorted({
        e[5] for e in flight_recorder.recorder().entries()
        if str(e[3]).startswith("tp_attention.fallback")})
    np.savez(os.path.join(OUT, f"rank{rank}.npz"), **res)
    with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    C.barrier()
    C.destroy_process_group()


if __name__ == "__main__":
    main()
