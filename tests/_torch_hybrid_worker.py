"""One rank of ``tests/test_torch_hybrid_parallel.py``'s world-4 launch.

Started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 4 --devices cpu tests/_torch_hybrid_worker.py DIR``.
It waits for ``DIR/inputs.npz`` (written by the test, after the launch,
from the JAX package's weights and seeded numpy inputs), runs the port's
parts over gloo on the CPU, and writes ``DIR/rank<r>.npz`` and ``DIR/rank<r>.json``:

1. dp 2 x mp 2: the four mp layers alone (outputs, the input's grad, the
   weight shards' grads); the tiny Llama cut by ``shard_state_dict`` under
   ``DataParallel`` (its loss, grads, and parameters after three AdamW
   steps with an active global-norm clip); a checksum of every parameter
   for the dp replicas; ``SyncBatchNorm2D`` over the dp group and the
   ``sync_batch_norm`` entry; ``flash_attn_unpadded`` on the rank's heads;
   ``DataParallel`` over all four ranks on a small net;
2. dp 1 x mp 4: the tiny config's 4 / 2 heads (kv heads do not cut) and a
   2 / 2-head config (heads do not cut): the loss and the
   ``tp_attention`` counters and flight-recorder keys.

Only the port is imported here (no JAX).
"""

import hashlib
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
                                     from_jax_state_dict, shard_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import flight_recorder
from paddle_tpu_torch.ops.dispatcher import call_op
from paddle_tpu_torch.ops.kernels import tp_attention
from paddle_tpu_torch.optimizer import AdamW

OUT = sys.argv[1]
INPUTS_WAIT_S = 120       # the test writes the inputs after the launch
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
    return torch.from_numpy(inp[name])


def strategy(dp, mp):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    return s


def cut(full, dim, group):
    n = full.shape[dim] // group.nranks
    return full.narrow(dim, group.rank * n, n).clone()


def mp_layers(hcg):
    """Each layer fed the same full input on every rank."""
    g = hcg.get_model_parallel_group()
    x = t("x").requires_grad_(True)
    for name, gather in (("col_gather", True), ("col", False)):
        layer = fleet.ColumnParallelLinear(16, 32, gather_output=gather)
        with torch.no_grad():
            layer.weight.copy_(cut(t("col_w"), 1, g))
            layer.bias.copy_(cut(t("col_b"), 0, g))
        y = layer(x)
        (y * (cut(t("col_ct"), 1, g) if not gather else t("col_ct"))
         ).sum().backward()
        res[f"{name}_y"] = y.detach().numpy()
        res[f"{name}_dx"] = x.grad.numpy().copy()
        res[f"{name}_dw"] = layer.weight.grad.numpy()
        x.grad = None
    for name, parallel in (("row", False), ("row_par", True)):
        layer = fleet.RowParallelLinear(32, 16, input_is_parallel=parallel)
        with torch.no_grad():
            layer.weight.copy_(cut(t("row_w"), 0, g))
            layer.bias.copy_(t("row_b"))
        h = t("h").requires_grad_(True)
        y = layer(cut(h, 1, g) if parallel else h)
        (y * t("row_ct")).sum().backward()
        res[f"{name}_y"] = y.detach().numpy()
        res[f"{name}_dh"] = h.grad.numpy()
        res[f"{name}_dw"] = layer.weight.grad.numpy()
    emb = fleet.VocabParallelEmbedding(64, 8)
    with torch.no_grad():
        emb.weight.copy_(cut(t("emb_w"), 0, g))
    y = emb(t("emb_ids"))
    (y * t("emb_ct")).sum().backward()
    res["emb_y"] = y.detach().numpy()
    res["emb_dw"] = emb.weight.grad.numpy()
    logits = cut(t("ce_logits"), 1, g).requires_grad_(True)
    loss = fleet.ParallelCrossEntropy()(logits, t("ce_labels"))
    loss.sum().backward()
    res["ce_loss"] = loss.detach().numpy()
    res["ce_dlogits"] = logits.grad.numpy()


def llama(hcg, cfg, ids, steps, clip):
    """The cut model under fleet's wrappers: the first loss and grads,
    then ``steps`` AdamW steps; the losses are averaged over dp."""
    model = LlamaForCausalLM(cfg, device="cpu")
    full = {k[6:]: v for k, v in inp.items() if k.startswith("llama/")}
    from_jax_state_dict(model, shard_state_dict(model, full))
    dp = hcg.get_data_parallel_group()
    rows = ids.shape[0] // dp.nranks
    mine = torch.from_numpy(ids[dp.rank * rows:(dp.rank + 1) * rows])
    net = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(clip)))
    crit, losses, grads = LlamaPretrainingCriterion(), [], None
    for step in range(steps):
        loss = crit(net(mine), mine)
        loss.backward()
        if grads is None:
            grads = {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        avg = loss.detach().reshape(1).clone()
        C.all_reduce(avg, op=C.ReduceOp.AVG, group=dp)
        losses.append(float(avg))
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    return losses, grads, params


def checksums(params):
    return {n: hashlib.sha256(v.tobytes()).hexdigest()
            for n, v in params.items()}


def hybrid(hcg):
    cfg = LlamaConfig.tiny()
    before = tp_attention.counters()
    losses, grads, params = llama(hcg, cfg, inp["ids"], 3,
                                  float(inp["clip"]))
    after = tp_attention.counters()
    meta["llama_losses"] = losses
    meta["tp_counters"] = {k: after[k] - before[k] for k in after}
    for n, v in grads.items():
        res[f"grad/{n}"] = v
    for n, v in params.items():
        res[f"param/{n}"] = v
    meta["checksums"] = checksums(params)
    meta["dp_rank"] = hcg.get_data_parallel_rank()
    meta["mp_rank"] = hcg.get_model_parallel_rank()


def sync_bn(hcg):
    dp = hcg.get_data_parallel_group()
    bn = paddle.nn.SyncBatchNorm.convert_sync_batchnorm(
        paddle.nn.BatchNorm2D(int(inp["bn_x"].shape[1])))
    rows = inp["bn_x"].shape[0] // dp.nranks
    x = t("bn_x")[dp.rank * rows:(dp.rank + 1) * rows].clone()
    x.requires_grad_(True)
    y = bn(x)
    (y * t("bn_ct")[dp.rank * rows:(dp.rank + 1) * rows]).sum().backward()
    res["bn_y"] = y.detach().numpy()
    res["bn_dx"] = x.grad.numpy()
    res["bn_mean"] = bn._mean.numpy()
    res["bn_var"] = bn._variance.numpy()
    c = int(inp["bn_x"].shape[1])
    out = call_op("sync_batch_norm", x.detach(), torch.zeros(c),
                  torch.ones(c), torch.ones(c), torch.zeros(c))
    res["bn_op_y"] = out[0].numpy()
    res["bn_op_mean"] = out[1].numpy()


def varlen(hcg):
    """``flash_attn_unpadded`` under mp 2: this rank's heads of q/k/v."""
    g = hcg.get_model_parallel_group()
    q, k, v = (cut(t(n), 1, g).requires_grad_(True)
               for n in ("vl_q", "vl_k", "vl_v"))
    before = tp_attention.counters()["sharded"]
    out = call_op("flash_attn_unpadded", q, k, v, t("vl_cu"), t("vl_cu"),
                  0, 0, 0.0, True)
    (out * cut(t("vl_ct"), 1, g)).sum().backward()
    meta["varlen_sharded"] = tp_attention.counters()["sharded"] - before
    res["vl_out"] = out.detach().numpy()
    res["vl_dq"] = q.grad.numpy()


def data_parallel():
    """DataParallel over the four ranks: each rank's quarter of the
    batch, the grads averaged."""
    torch.manual_seed(0)
    net = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                               paddle.nn.Linear(16, 4))
    with torch.no_grad():
        for i, p in enumerate(net.parameters()):
            p.copy_(t(f"dp_p{i}"))
    dpn = paddle.DataParallel(net, group=C.new_group(list(range(4))),
                              comm_buffer_size=0.0002,
                              last_comm_buffer_size=0.0001)
    meta["dp_buckets"] = len(dpn.buckets)
    r = C.get_rank()
    x = t("dp_x")[r * 4:(r + 1) * 4]
    loss = (dpn(x) - t("dp_y")[r * 4:(r + 1) * 4]).square().mean()
    loss.backward()
    for i, p in enumerate(net.parameters()):
        res[f"dp_grad{i}"] = p.grad.numpy()


def taxonomy():
    """dp 1 x mp 4: the heads that do not cut, per config."""
    hcg = fleet.init(is_collective=True, strategy=strategy(1, 4))
    for name, heads in (("kv", (4, 2)), ("q", (2, 2))):
        cfg = LlamaConfig.tiny()
        cfg.num_attention_heads, cfg.num_key_value_heads = heads
        model = LlamaForCausalLM(cfg, device="cpu")
        pre = "llama/" if name == "kv" else "tax_q/"
        full = {k[len(pre):]: v for k, v in inp.items()
                if k.startswith(pre)}
        from_jax_state_dict(model, shard_state_dict(model, full, hcg))
        before = tp_attention.counters()
        flight_recorder.recorder().clear()
        ids = torch.from_numpy(inp["ids"])
        with torch.no_grad():
            loss = LlamaPretrainingCriterion()(model(ids), ids)
        after = tp_attention.counters()
        keys = sorted({e[5] for e in flight_recorder.recorder().entries()
                       if e[3].startswith("tp_attention.fallback")})
        meta[f"tax_{name}"] = {
            "loss": float(loss), "keys": keys,
            "counters": {k: after[k] - before[k] for k in after}}


def main():
    C.init_parallel_env(backend="gloo")
    load_inputs()
    r = C.get_rank()
    hcg = fleet.init(is_collective=True, strategy=strategy(2, 2))
    meta["degrees"] = [hcg.get_data_parallel_world_size(),
                       hcg.get_model_parallel_world_size()]
    mp_layers(hcg)
    hybrid(hcg)
    sync_bn(hcg)
    varlen(hcg)
    data_parallel()
    taxonomy()
    meta["collective_calls"] = paddle.observability.metrics.registry().get(
        "distributed.collective_calls").value
    np.savez(os.path.join(OUT, f"rank{r}.npz"), **res)
    with open(os.path.join(OUT, f"rank{r}.json"), "w") as f:
        json.dump(meta, f)
    C.barrier()
    C.destroy_process_group()


if __name__ == "__main__":
    main()
