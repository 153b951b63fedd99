"""The port's hybrid parallelism against the JAX package's, on the CPU.

The reference is one process over 8 virtual devices; the port is one
process per rank. So the topology is compared in process, and the rest
comes from ONE world-4 launch of ``tests/_torch_hybrid_worker.py``
through the port's launcher (gloo, ``--devices cpu``), which writes each
rank's results to a temporary directory; the reference side runs here
while the ranks run. Held, float32, atol 1e-5 / rtol 1e-4 unless said:

- ``CommunicateTopology`` and ``HybridCommunicateGroup`` against the
  reference's (``tests/test_distributed.py:112-131``), no processes;
- the four mp layers alone at dp 2 x mp 2 (outputs and grads, shards
  gathered) against the reference's layers on the whole weights;
- the tiny Llama at dp 2 x mp 2 (weights cut by ``shard_state_dict``),
  the reference's at dp 4 x mp 2 with the same global batch: the first
  loss. The reference's mp > 1 Llama has no grads (its
  ``ColumnParallelLinear(gather_output=True)`` leaves the tape, ROADMAP.md
  §C), so the grads (shards gathered) and the parameters after three
  AdamW steps under an active global-norm clip are held to the
  reference's single-device model, the same function of the same batch
  (seq 64: the reference's attention takes its composite there, the
  port's its flash path, on the CPU the plain version);
- the dp replicas bit for bit; ``DataParallel`` over four ranks against
  the single-process mean; ``SyncBatchNorm2D`` over dp (and the
  ``sync_batch_norm`` entry) against the reference's ``BatchNorm2D`` over
  the whole batch (1e-5 relative); ``flash_attn_unpadded`` on a rank's
  heads against the reference's varlen composite over all of them;
- at dp 1 x mp 4, the taxonomy keys the reference records for the tiny
  config's 4 / 2 heads (``kv_heads_indivisible``) and a 2 / 2-head one
  (``heads_indivisible``), and the losses there.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as rpaddle
import paddle_tpu.distributed as rdist
import paddle_tpu.nn as rnn
from paddle_tpu import optimizer as RO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.models import LlamaConfig as RConfig
from paddle_tpu.models import LlamaForCausalLM as RModel
from paddle_tpu.models import LlamaPretrainingCriterion as RCrit
from paddle_tpu.observability import flight_recorder as rflight
from paddle_tpu.observability import metrics as rmetrics

from _torch_ref_state import reference_executables_dropped  # noqa: F401
from paddle_tpu_torch.distributed import (AXIS_ORDER, CommunicateTopology,
                                          HybridCommunicateGroup)
from paddle_tpu_torch.distributed.launch import kill_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_hybrid_worker.py")
LAUNCH_TIMEOUT_S = 150
CLIP = 0.05              # below the tiny model's grad norm: the clip acts
ATOL, RTOL = 1e-5, 1e-4


def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x, np.float32)


def _state(m):
    return {k: _np(v) for k, v in m.state_dict().items()}


def _rng(seed):
    return np.random.RandomState(seed)


def _strategy(dp, mp):
    s = rdist.fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    return s


def _tiny(heads=None):
    cfg = RConfig.tiny()
    if heads is not None:
        cfg = dataclasses.replace(cfg, num_attention_heads=heads[0],
                                  num_key_value_heads=heads[1])
    return cfg


def _inputs():
    r = _rng(0)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    inp = {"x": f(4, 16), "col_w": f(16, 32), "col_b": f(32),
           "col_ct": f(4, 32), "h": f(4, 32), "row_w": f(32, 16),
           "row_b": f(16), "row_ct": f(4, 16), "emb_w": f(64, 8),
           "emb_ids": r.randint(0, 64, (3, 5)).astype(np.int64),
           "emb_ct": f(3, 5, 8), "ce_logits": f(4, 8),
           "ce_labels": np.array([1, 5, 3, 7], np.int64),
           "ids": r.randint(0, 256, (4, 64)).astype(np.int32),
           "clip": np.float32(CLIP), "bn_x": f(8, 3, 5, 5),
           "bn_ct": f(8, 3, 5, 5), "dp_x": f(16, 8), "dp_y": f(16, 4)}
    for i, shape in enumerate([(8, 16), (16,), (16, 4), (4,)]):
        inp[f"dp_p{i}"] = f(*shape)
    inp.update(vl_q=f(40, 4, 16), vl_k=f(40, 2, 16), vl_v=f(40, 2, 16),
               vl_ct=f(40, 4, 16), vl_cu=np.array([0, 13, 40], np.int32))
    rpaddle.seed(0)
    models = {"llama": RModel(_tiny())}
    rpaddle.seed(2)
    models["tax_q"] = RModel(_tiny((2, 2)))
    for tag, m in models.items():
        inp.update({f"{tag}/{k}": v for k, v in _state(m).items()})
    return inp, models


def _tax_state(inp, tag):
    """The taxonomy run's weights: the tiny model's for its 4 / 2 heads,
    their own for the 2 / 2 heads."""
    pre = "llama/" if tag == "kv" else "tax_q/"
    return {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}


def _launch(out):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "4", "--devices", "cpu", "--max_restart", "0",
           "--log_dir", os.path.join(out, "log"), "--job_id", "hybrid",
           WORKER, out]
    # a session of its own: the launcher and its ranks are one group
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _train(m, ids, steps):
    opt = RO.AdamW(learning_rate=1e-3, weight_decay=0.01,
                   parameters=m.parameters(),
                   grad_clip=rnn.ClipGradByGlobalNorm(CLIP))
    losses, grads = [], None
    for _ in range(steps):
        loss = RCrit()(m(Tensor(ids)), Tensor(ids))
        loss.backward()
        if grads is None:
            grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss._data))
    return losses, grads, {n: _np(p) for n, p in m.named_parameters()}


def _tp_loss(cfg, state, ids, dp, mp):
    """The reference's loss under dp x mp, and its tp_attention counter
    deltas and recorded fallback keys."""
    rdist.fleet.init(is_collective=True, strategy=_strategy(dp, mp))
    m = RModel(cfg)
    m.set_state_dict({k: Tensor(v) for k, v in state.items()})
    reg = rmetrics.registry()
    before = {k: reg.counter(f"tp_attention.{k}").value
              for k in ("sharded", "fallback")}
    rflight.recorder().clear()
    loss = float(RCrit()(m(Tensor(ids)), Tensor(ids))._data)
    keys = sorted({e[5] for e in rflight.recorder().entries()
                   if str(e[3]).startswith("tp_attention.fallback")})
    delta = {k: reg.counter(f"tp_attention.{k}").value - before[k]
             for k in before}
    return loss, delta, keys


def _set(layer, **arrays):
    missing, unexpected = layer.set_state_dict(arrays)
    assert not missing and not unexpected


def _layers_reference(inp):
    """The four layers' outputs and grads: the reference's layers on the
    whole weights (its mp layers' forwards are its plain ones under
    GSPMD; their backward leaves the tape where the output is gathered,
    ROADMAP.md §C)."""
    out = {}
    x = rpaddle.to_tensor(inp["x"], stop_gradient=False)
    col = rnn.Linear(16, 32)
    _set(col, weight=inp["col_w"], bias=inp["col_b"])
    y = col(x)
    (y * rpaddle.to_tensor(inp["col_ct"])).sum().backward()
    out.update(col_y=_np(y), col_dx=_np(x.grad), col_dw=_np(col.weight.grad))
    h = rpaddle.to_tensor(inp["h"], stop_gradient=False)
    row = rnn.Linear(32, 16)
    _set(row, weight=inp["row_w"], bias=inp["row_b"])
    y = row(h)
    (y * rpaddle.to_tensor(inp["row_ct"])).sum().backward()
    out.update(row_y=_np(y), row_dh=_np(h.grad), row_dw=_np(row.weight.grad))
    emb = rnn.Embedding(64, 8)
    _set(emb, weight=inp["emb_w"])
    y = emb(rpaddle.to_tensor(inp["emb_ids"].astype(np.int32)))
    (y * rpaddle.to_tensor(inp["emb_ct"])).sum().backward()
    out.update(emb_y=_np(y), emb_dw=_np(emb.weight.grad))
    logits = rpaddle.to_tensor(inp["ce_logits"], stop_gradient=False)
    loss = rnn.functional.softmax_with_cross_entropy(
        logits, rpaddle.to_tensor(inp["ce_labels"][:, None].astype(np.int32)))
    loss.sum().backward()
    out.update(ce_loss=_np(loss), ce_dlogits=_np(logits.grad))
    return out


def _varlen_reference(inp):
    """The reference's varlen composite over every head, and dq."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.kernels.pallas import flash_varlen as rfv
    cu = jnp.asarray(inp["vl_cu"])

    def f(q):
        return rfv.varlen_composite(q, jnp.asarray(inp["vl_k"]),
                                    jnp.asarray(inp["vl_v"]), cu, cu,
                                    causal=True)
    out, vjp = jax.vjp(f, jnp.asarray(inp["vl_q"]))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(inp["vl_ct"]))[0])


def _bn_reference(inp):
    bn = rnn.BatchNorm2D(inp["bn_x"].shape[1])
    bn.train()
    x = rpaddle.to_tensor(inp["bn_x"], stop_gradient=False)
    y = bn(x)
    (y * rpaddle.to_tensor(inp["bn_ct"])).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad), "mean": _np(bn._mean),
            "var": _np(bn._variance)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hybrid"))
    saved = rtopo.get_hybrid_communicate_group()
    rtopo.set_hybrid_communicate_group(None)
    t0 = time.perf_counter()
    proc = _launch(out)     # the ranks import while the inputs are made
    try:
        inp, models = _inputs()
        np.savez(os.path.join(out, "inputs.tmp.npz"), **inp)
        os.replace(os.path.join(out, "inputs.tmp.npz"),
                   os.path.join(out, "inputs.npz"))
        ref = {"layers": _layers_reference(inp), "bn": _bn_reference(inp),
               "varlen": _varlen_reference(inp)}
        rtopo.set_hybrid_communicate_group(None)
        ref["single"] = _train(models["llama"], inp["ids"], 3)
        state = {k[6:]: v for k, v in inp.items() if k.startswith("llama/")}
        ref["tp_loss"] = _tp_loss(_tiny(), state, inp["ids"], 4, 2)
        for tag, heads in (("kv", (4, 2)), ("q", (2, 2))):
            ref[f"tax_{tag}"] = _tp_loss(_tiny(heads), _tax_state(inp, tag),
                                         inp["ids"], 2, 4)
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        kill_group(proc)
        rtopo.set_hybrid_communicate_group(saved)
    assert proc.returncode == 0, log[-4000:]
    ranks = [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
              json.load(open(os.path.join(out, f"rank{r}.json"))))
             for r in range(4)]
    print(f"hybrid parallel: {time.perf_counter() - t0:.1f} s")
    return inp, ref, ranks


@pytest.fixture(autouse=True)
def _on_cpu():
    from paddle_tpu_torch.core.device import set_device
    set_device("cpu")
    yield
    set_device(None)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# -- topology (no processes) --------------------------------------------------

def test_comm_topology_matches_reference():
    for dims in ([2, 1, 1, 1, 4], [2, 1, 1, 1, 2], [1, 1, 1, 1, 4]):
        mine = CommunicateTopology(AXIS_ORDER, dims)
        ref = rdist.CommunicateTopology(rdist.AXIS_ORDER, dims)
        assert mine.world_size() == ref.world_size()
        for r in range(ref.world_size()):
            assert mine.get_coord(r) == ref.get_coord(r)
        for axis in AXIS_ORDER:
            assert mine.get_comm_list(axis) == ref.get_comm_list(axis)
            assert mine.get_axis_list(axis, 0) == ref.get_axis_list(axis, 0)
    assert CommunicateTopology(AXIS_ORDER, [2, 1, 1, 1, 4]).get_rank(
        data=1, pipe=0, sharding=0, sep=0, model=2) == 6


@pytest.mark.parametrize("rank", range(8))
def test_hcg_accessors_per_rank(rank):
    topo = CommunicateTopology(AXIS_ORDER, [2, 1, 1, 1, 4])
    hcg = HybridCommunicateGroup(topo, rank=rank, world_size=8)
    assert hcg.get_model_parallel_world_size() == 4
    assert hcg.get_data_parallel_world_size() == 2
    assert hcg.mesh.shape == [2, 1, 1, 1, 4]
    mp, dp = hcg.get_model_parallel_group(), hcg.get_data_parallel_group()
    assert mp.axis == "mp" and mp.ranks == [rank // 4 * 4 + i
                                            for i in range(4)]
    assert dp.axis == "dp" and dp.ranks == [rank % 4, rank % 4 + 4]
    assert hcg.get_model_parallel_rank() == rank % 4
    assert hcg.get_data_parallel_rank() == rank // 4
    assert hcg.get_global_rank() == rank


def test_wrong_degree_product_raises():
    with pytest.raises(ValueError):
        HybridCommunicateGroup(
            CommunicateTopology(AXIS_ORDER, [3, 1, 1, 1, 4]), rank=0,
            world_size=8)
    with pytest.raises(ValueError):
        rdist.HybridCommunicateGroup(
            rdist.CommunicateTopology(rdist.AXIS_ORDER, [3, 1, 1, 1, 4]))


# -- the launch ---------------------------------------------------------------

def test_ranks_took_dp2_mp2(run):
    _, _, ranks = run
    assert [m["degrees"] for _, m in ranks] == [[2, 2]] * 4
    assert [(m["dp_rank"], m["mp_rank"]) for _, m in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def _mp_cat(ranks, key, dim, mp_of=lambda r: r % 2):
    """The two mp shards of dp replica 0, concatenated on ``dim``."""
    return np.concatenate([ranks[r][0][key] for r in (0, 1)], axis=dim)


@pytest.mark.parametrize("layer", ["column", "column_gathered", "row",
                                   "row_parallel_input", "vocab_embedding",
                                   "cross_entropy"])
def test_mp_layer_matches_reference(run, layer):
    _, ref, ranks = run
    lr = ref["layers"]
    for r, (res, _) in enumerate(ranks):
        if layer == "column":
            mp = r % 2
            _close(res["col_y"], np.split(lr["col_y"], 2, 1)[mp])
            _close(_mp_cat(ranks, "col_dw", 1), lr["col_dw"])
            _close(res["col_dx"], lr["col_dx"])
        elif layer == "column_gathered":
            _close(res["col_gather_y"], lr["col_y"])
            _close(res["col_gather_dx"], lr["col_dx"])
            _close(_mp_cat(ranks, "col_gather_dw", 1), lr["col_dw"])
        elif layer == "row":
            _close(res["row_y"], lr["row_y"])
            _close(res["row_dh"], lr["row_dh"])
            _close(_mp_cat(ranks, "row_dw", 0), lr["row_dw"])
        elif layer == "row_parallel_input":
            _close(res["row_par_y"], lr["row_y"])
            _close(ranks[r - r % 2][0]["row_par_dh"]
                   + ranks[r - r % 2 + 1][0]["row_par_dh"], lr["row_dh"])
        elif layer == "vocab_embedding":
            _close(res["emb_y"], lr["emb_y"])
            _close(_mp_cat(ranks, "emb_dw", 0), lr["emb_dw"])
        else:
            _close(res["ce_loss"], lr["ce_loss"])
            _close(_mp_cat(ranks, "ce_dlogits", 1), lr["ce_dlogits"])


def test_first_loss_matches_reference_tp_and_single(run):
    _, ref, ranks = run
    single_losses = ref["single"][0]
    tp_loss = ref["tp_loss"][0]
    for _, meta in ranks:
        assert abs(meta["llama_losses"][0] - tp_loss) < ATOL + RTOL * tp_loss
        np.testing.assert_allclose(meta["llama_losses"], single_losses,
                                   atol=ATOL, rtol=RTOL)


def _gathered(ranks, prefix, shapes, dp=0):
    """Every parameter's tensor of dp replica ``dp``, mp shards put back
    together along the dim they were cut on (found from the shapes)."""
    out = {}
    a, b = ranks[2 * dp][0], ranks[2 * dp + 1][0]
    for name, shape in shapes.items():
        x, y = a[f"{prefix}/{name}"], b[f"{prefix}/{name}"]
        if x.shape == tuple(shape):
            out[name] = x
            assert np.array_equal(x, y), name   # replicated over mp
        else:
            dim = next(d for d in range(x.ndim) if x.shape[d] != shape[d])
            out[name] = np.concatenate([x, y], axis=dim)
    return out


def test_grads_match_reference(run):
    _, ref, ranks = run
    want = ref["single"][1]
    got = _gathered(ranks, "grad", {n: v.shape for n, v in want.items()})
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in want.values()))
    assert norm > CLIP          # the clip acts in the steps below
    for name, g in want.items():
        _close(got[name], g)


def test_params_after_three_clipped_adamw_steps(run):
    _, ref, ranks = run
    want = ref["single"][2]
    for dp in (0, 1):
        got = _gathered(ranks, "param", {n: v.shape for n, v in
                                         want.items()}, dp)
        for name, p in want.items():
            _close(got[name], p)


def test_dp_replicas_are_bit_for_bit_equal(run):
    _, _, ranks = run
    for mp in (0, 1):
        assert ranks[mp][1]["checksums"] == ranks[2 + mp][1]["checksums"]


def test_attention_ran_the_kernel_path_on_local_heads(run):
    _, _, ranks = run
    for _, meta in ranks:
        assert meta["tp_counters"]["sharded"] > 0
        assert meta["tp_counters"]["fallback"] == 0


def test_data_parallel_grads_equal_single_process_mean(run):
    inp, _, ranks = run
    import paddle_tpu_torch as tp
    net = tp.nn.Sequential(tp.nn.Linear(8, 16, bias_attr=None),
                           tp.nn.ReLU(), tp.nn.Linear(16, 4))
    with torch.no_grad():
        for i, p in enumerate(net.parameters()):
            p.copy_(torch.from_numpy(inp[f"dp_p{i}"]))
    x, y = torch.from_numpy(inp["dp_x"]), torch.from_numpy(inp["dp_y"])
    (net(x) - y).square().mean().backward()
    for res, meta in ranks:
        assert meta["dp_buckets"] > 1
        for i, p in enumerate(net.parameters()):
            _close(res[f"dp_grad{i}"], p.grad.numpy(), atol=1e-6, rtol=1e-5)


def test_sync_batch_norm_matches_global_batch_norm(run):
    _, ref, ranks = run
    want = ref["bn"]
    for dp in (0, 1):
        res = ranks[2 * dp][0]
        rows = res["bn_y"].shape[0]
        sl = slice(dp * rows, (dp + 1) * rows)
        _close(res["bn_y"], want["y"][sl], atol=1e-5, rtol=1e-5)
        _close(res["bn_dx"], want["dx"][sl], atol=1e-5, rtol=1e-5)
        _close(res["bn_mean"], want["mean"], atol=1e-6, rtol=1e-5)
        _close(res["bn_var"], want["var"], atol=1e-6, rtol=1e-5)


def test_sync_batch_norm_entry_matches_the_layer(run):
    _, ref, ranks = run
    for res, _ in ranks:
        np.testing.assert_array_equal(res["bn_op_y"], res["bn_y"])
        _close(res["bn_op_mean"], ref["bn"]["mean"], atol=1e-6, rtol=1e-5)


def test_varlen_on_local_heads_matches_reference(run):
    _, ref, ranks = run
    out, dq = ref["varlen"]
    for r, (res, meta) in enumerate(ranks):
        heads = slice(2 * (r % 2), 2 * (r % 2) + 2)
        assert meta["varlen_sharded"] == 1
        _close(res["vl_out"], out[:, heads])
        _close(res["vl_dq"], dq[:, heads])


@pytest.mark.parametrize("tag,key", [("kv", "kv_heads_indivisible"),
                                     ("q", "heads_indivisible")])
def test_indivisible_heads_record_the_reference_taxonomy(run, tag, key):
    _, ref, ranks = run
    rloss, rdelta, rkeys = ref[f"tax_{tag}"]
    assert rkeys == [key] and rdelta["fallback"] > 0
    for _, meta in ranks:
        mine = meta[f"tax_{tag}"]
        assert mine["keys"] == [key]
        assert mine["counters"]["fallback"] > 0
        assert mine["counters"]["sharded"] == 0
        assert abs(mine["loss"] - rloss) < ATOL + RTOL * abs(rloss)


def test_hybrid_clip_counts_a_replicated_parameter_once(monkeypatch):
    """torch's ``Parameter`` has a method ``is_distributed``, truthy on
    every parameter: only the flag the mp layers set marks one cut over
    mp. Over a stand-in mp group of two ranks whose all-reduce doubles
    (the other rank's shard as large), the replicated parameter's squares
    count once and the cut one's twice."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.mp_layers import _distributed
    whole = torch.nn.Parameter(torch.zeros(3))
    cut = _distributed(torch.nn.Parameter(torch.zeros(2)))
    monkeypatch.setattr(C, "all_reduce",
                        lambda t, op="sum", group=None: t.mul_(2))
    clip = fleet.HybridParallelClipGrad(1.0, C.Group("model", 2, [0, 1]))
    total = clip.sum_of_squares(
        [torch.tensor([1.0, 2.0, 2.0]), torch.tensor([3.0, 4.0])],
        [whole, cut])
    assert float(total) == 9.0 + 2 * 25.0
