"""The port's pipeline against the JAX package's, on the CPU.

- The schedule tables (``pp_schedules.build_fb_schedule`` for FThenB,
  1F1B and Eager1F1B, ``pipeline.build_vpp_schedule``) equal the
  reference's for every S <= 4 and M <= 8, in process.
- ONE world-4 launch of ``tests/_torch_pipeline_worker.py`` (gloo,
  ``--devices cpu``) runs the multi-process runtime while the reference
  runs here on the same numpy inputs and weights: the tiny Llama built
  under pp 2 (dp 2) and pp 4, 1F1B, FThenB and interleaved (VPP, 2
  virtual stages), against the reference's ``pipelined_stack_forward``
  (its Llama under the same pp degree, accumulate steps and
  ``virtual_pp_degree``) on the same stacked weights: the loss (the mean
  of the dp replicas' losses) and every grad, float32, atol 1e-5 / rtol
  1e-4 (``ATOL``, ``RTOL``); at pp 4 also two AdamW steps with an active
  global-norm clip; a ``PipelineLayer`` with a ``SharedLayerDesc`` on the
  first and the last stage against the reference's ``PipelineLayer`` on
  one stage: loss, grads (the shared weight's summed over its two uses),
  two SGD steps and an ``eval_batch``.

The runtime's schedule ops are checked too: each stage runs every forward
and backward of its chunks exactly once.
"""

import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as rpaddle
import paddle_tpu.distributed as rdist
import paddle_tpu.nn as rnn
from paddle_tpu import optimizer as RO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import pipeline as rpipe
from paddle_tpu.distributed import pp_schedules as rsched
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.distributed.fleet import pp_layers as rpp
from paddle_tpu.models import LlamaConfig as RConfig
from paddle_tpu.models import LlamaForCausalLM as RModel
from paddle_tpu.models import LlamaPretrainingCriterion as RCrit

from _torch_ref_state import reference_executables_dropped  # noqa: F401
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed import pp_schedules as tsched
from paddle_tpu_torch.distributed.launch import kill_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_pipeline_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _torch_pipeline_worker import CASES  # noqa: E402

LAUNCH_TIMEOUT_S = 150
CLIP = 0.05
ATOL, RTOL = 1e-5, 1e-4


def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x, np.float32)


def _cfg(layers):
    return RConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=layers, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=128,
                   use_scan_layers=True)


# -- the tables (in process) --------------------------------------------------

@pytest.mark.parametrize("kind", tsched.SCHEDULES)
@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("S", range(1, 5))
def test_fb_schedule_table_equals_reference(S, M, kind):
    mine, ref = tsched.build_fb_schedule(S, M, kind), \
        rsched.build_fb_schedule(S, M, kind)
    assert mine["T"] == ref["T"] and mine["peak_live"] == ref["peak_live"]
    assert mine["bubble"] == ref["bubble"]
    np.testing.assert_array_equal(mine["phase"], ref["phase"])
    np.testing.assert_array_equal(mine["mb"], ref["mb"])


@pytest.mark.parametrize("v", [2, 3])
@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("S", range(1, 5))
def test_vpp_schedule_table_equals_reference(S, M, v):
    mine, ref = tpipe.build_vpp_schedule(S, M, v), \
        rpipe.build_vpp_schedule(S, M, v)
    for k in ("recv_slot", "src_slot", "inject_mb", "chunk_sel", "out_mb"):
        np.testing.assert_array_equal(mine[k], ref[k])
    assert (mine["T"], mine["B"], mine["busy"]) == \
        (ref["T"], ref["B"], ref["busy"])
    assert tpipe.vpp_bubble_fraction(S, M, v) == \
        rpipe.vpp_bubble_fraction(S, M, v)


def test_schedule_report_equals_reference():
    assert tsched.schedule_report(4, 8) == rsched.schedule_report(4, 8)


@pytest.mark.parametrize("v", [1, 2])
def test_each_stage_runs_every_op_once(v):
    S, M = 4, 8
    ops = tpipe.schedule_ops(S, M, v, "1F1B")
    for d in range(S):
        mine = {(kind, m, k) for _, kind, m, k in ops[d]}
        want = {(kind, m, k) for kind in "FB" for m in range(M)
                for k in range(S * v) if k % S == d}
        assert mine == want and len(ops[d]) == len(want)


# -- the launch ---------------------------------------------------------------

def _launch(out):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "4", "--devices", "cpu", "--max_restart", "0",
           "--log_dir", os.path.join(out, "log"), "--job_id", "pp",
           WORKER, out]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _inputs():
    r = np.random.RandomState(0)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    inp = {"ids": r.randint(0, 256, (4, 16)).astype(np.int32),
           "clip": np.float32(CLIP), "pl_x": f(8, 8), "pl_y": f(8, 8),
           "pl_w": f(4, 8, 8) * 0.5, "pl_b": f(4, 8) * 0.1,
           "pl_tie_w": f(8, 8) * 0.5}
    for layers in (4, 8):
        rtopo.set_hybrid_communicate_group(None)
        rpaddle.seed(0)
        m = RModel(_cfg(layers))
        inp.update({f"L{layers}/{k}": _np(v)
                    for k, v in m.state_dict().items()})
    return inp


def _llama_reference(inp, pp, v, M, layers, steps=0):
    s = rdist.fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": pp}
    s.pipeline_configs = {"accumulate_steps": M, "micro_batch_size": 1,
                          "schedule_mode": "", "virtual_pp_degree": v}
    rdist.fleet.init(is_collective=True, strategy=s)
    m = RModel(_cfg(layers))
    pre = f"L{layers}/"
    m.set_state_dict({k[len(pre):]: Tensor(jnp.asarray(a))
                      for k, a in inp.items() if k.startswith(pre)})
    net = rdist.fleet.distributed_model(m)
    ids = Tensor(jnp.asarray(inp["ids"]))
    loss = RCrit()(net(ids), ids)
    loss.backward()
    out = {"loss": float(loss._data),
           "grads": {n: _np(p.grad) for n, p in m.named_parameters()}}
    if steps:
        opt = RO.AdamW(learning_rate=1e-3, weight_decay=0.01,
                       parameters=m.parameters(),
                       grad_clip=rnn.ClipGradByGlobalNorm(CLIP))
        opt.clear_grad()
        out["steps"] = []
        for _ in range(steps):
            loss = RCrit()(net(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            out["steps"].append(float(loss._data))
        out["params"] = {n: _np(p) for n, p in m.named_parameters()}
    return out


class _RLin(rnn.Layer):
    def __init__(self, i, o):
        super().__init__()
        self.weight = self.create_parameter((i, o))
        self.bias = self.create_parameter((o,), is_bias=True)

    def forward(self, x):
        return rpaddle.matmul(x, self.weight) + self.bias


class _RTie(rnn.Layer):
    def __init__(self, i, o):
        super().__init__()
        self.weight = self.create_parameter((i, o))

    def forward(self, x):
        return rpaddle.tanh(rpaddle.matmul(x, self.weight))


def _pipeline_layer_reference(inp):
    """The reference's PipelineLayer on one stage. Its ``_build_segment``
    keeps a shared-layer cache per segment, so its head and tail hold two
    copies of the tied layer (ROADMAP.md §C): both are given the tied
    weight, the tie's grad is the sum of the two copies', and SGD (lr 0.1)
    moves both by it, as one weight moves."""
    rtopo.set_hybrid_communicate_group(None)
    model = rpp.PipelineLayer(
        [rpp.SharedLayerDesc("tie", _RTie, None, "weight", 8, 8)]
        + [rpp.LayerDesc(_RLin, 8, 8) for _ in range(4)]
        + [rpp.SharedLayerDesc("tie", _RTie, None, "weight", 8, 8)],
        num_stages=1)
    x, y = (Tensor(jnp.asarray(inp[n])) for n in ("pl_x", "pl_y"))
    tie, w, b = inp["pl_tie_w"], inp["pl_w"], inp["pl_b"]

    def loss_and_grads(tie, w, b):
        missing, unexpected = model.set_state_dict({
            "head.0.weight": Tensor(jnp.asarray(tie)),
            "tail.0.weight": Tensor(jnp.asarray(tie)),
            "stack.stacked_0": Tensor(jnp.asarray(w)),
            "stack.stacked_1": Tensor(jnp.asarray(b))})
        assert not missing and not unexpected
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        st = model.stack.stacked_params()
        g = (_np(model.head[0].weight.grad) + _np(model.tail[0].weight.grad),
             _np(st[0].grad), _np(st[1].grad))
        for p in model.parameters():
            p.clear_gradient()
        return float(loss._data), g

    loss, (g_tie, g_w, g_b) = loss_and_grads(tie, w, b)
    out = {"loss": loss, "tie": g_tie, "w": g_w, "b": g_b, "steps": []}
    for _ in range(2):
        loss, g = loss_and_grads(tie, w, b)
        out["steps"].append(loss)
        tie, w, b = (p - 0.1 * d for p, d in zip((tie, w, b), g))
    out["eval"] = loss_and_grads(tie, w, b)[0]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pp"))
    saved = rtopo.get_hybrid_communicate_group()
    t0 = time.perf_counter()
    proc = _launch(out)
    try:
        inp = _inputs()
        np.savez(os.path.join(out, "inputs.tmp.npz"), **inp)
        os.replace(os.path.join(out, "inputs.tmp.npz"),
                   os.path.join(out, "inputs.npz"))
        ref = {}
        for name, (pp, v, M, _, layers) in CASES.items():
            rtopo.set_hybrid_communicate_group(None)
            ref[name] = _llama_reference(
                inp, pp, v, M, layers, steps=2 if name == "pp4_1f1b" else 0)
        ref["pl"] = _pipeline_layer_reference(inp)
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        kill_group(proc)
        rtopo.set_hybrid_communicate_group(saved)
    assert proc.returncode == 0, log[-4000:]
    ranks = [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
              json.load(open(os.path.join(out, f"rank{r}.json"))))
             for r in range(4)]
    print(f"pipeline: {time.perf_counter() - t0:.1f} s")
    return inp, ref, ranks


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _stage_view(want, rows):
    """The reference's full tensor ``want`` as the stage holds it."""
    return want if rows is None else want[np.asarray(rows)]


@pytest.mark.parametrize("case", list(CASES))
def test_llama_pipeline_loss_matches_reference(run, case):
    _, ref, ranks = run
    metas = [m[case] for _, m in ranks]
    assert {m["wrapper"] for m in metas} == {"PipelineParallel"}
    by_dp = {}
    for m in metas:
        by_dp.setdefault(m["dp_rank"], set()).add(round(m["loss"], 9))
    assert all(len(v) == 1 for v in by_dp.values())   # every stage agrees
    mean = np.mean([next(iter(v)) for v in by_dp.values()])
    _close(mean, ref[case]["loss"])


@pytest.mark.parametrize("case", list(CASES))
def test_llama_pipeline_grads_match_reference(run, case):
    _, ref, ranks = run
    want = ref[case]["grads"]
    S = CASES[case][0]
    held = set()
    for res, meta in ranks:
        m = meta[case]
        rows = m["rows"] or {}
        assert m["stage"] == (ranks.index((res, meta)) % S if S == 4 else
                              ranks.index((res, meta)) % 2)
        for name in m["names"]:
            _close(res[f"{case}/grad/{name}"],
                   _stage_view(want[name], rows.get(name)))
            held.add(name)
    assert held == set(want)              # every parameter on some stage


def test_llama_pipeline_stages_hold_their_parts(run):
    _, _, ranks = run
    for res, meta in ranks:
        m = meta["pp4_1f1b"]
        names = set(m["names"])
        assert ("llama.embed_tokens.weight" in names) == (m["stage"] == 0)
        assert ("lm_head.weight" in names) == (m["stage"] == 3)
        assert ("llama.norm.weight" in names) == (m["stage"] == 3)
        assert m["rows"]["llama.layer_stack.stacked_0"] == [m["stage"]]
        v = meta["pp4_vpp"]
        assert v["rows"]["llama.layer_stack.stacked_0"] == \
            [v["stage"], v["stage"] + 4]


def test_llama_pipeline_clipped_adamw_steps_match_reference(run):
    _, ref, ranks = run
    want = ref["pp4_1f1b"]
    for res, meta in ranks:
        m = meta["pp4_1f1b"]
        assert m["clip"] == "HybridParallelClipGrad"
        _close(m["steps"], want["steps"])
        rows = m["rows"]
        for name in m["names"]:
            _close(res[f"pp4_1f1b/param/{name}"],
                   _stage_view(want["params"][name], rows.get(name)))


def test_pipeline_layer_with_shared_weight_matches_reference(run):
    _, ref, ranks = run
    want = ref["pl"]
    for r, (res, meta) in enumerate(ranks):
        m = meta["pl"]
        assert m["stage"] == r
        _close(m["loss"], want["loss"])
        _close(m["steps"], want["steps"])
        _close(m["eval"], want["eval"])
        run_j = 1 if r == 0 else 0
        _close(res[f"pl/grad/{run_j}/weight"], want["w"][r])
        _close(res[f"pl/grad/{run_j}/bias"], want["b"][r])
        if r in (0, 3):
            tie_j = 0 if r == 0 else 1
            _close(res[f"pl/grad/{tie_j}/weight"], want["tie"])
            assert m["shared_copy"][tie_j] == (r == 3)


def test_llama_pipeline_averages_dp_through_data_parallel(run):
    """Over dp > 1 (pp 2 at world 4) the stage's grads are averaged by
    ``DataParallel``'s reducer, the one data-parallel reducer; at dp 1 the
    stage is not wrapped."""
    _, _, ranks = run
    for _, meta in ranks:
        for case, (pp, *_rest) in CASES.items():
            want = "DataParallel" if pp == 2 else "LlamaForCausalLM"
            assert meta[case]["reducer"] == want, case


def test_pipeline_under_sequence_parallelism_raises():
    """The pipeline does not cut its microbatches over sep: the combination
    raises before the job is joined, naming its ROADMAP item."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 2, "sep_degree": 2}
    with pytest.raises(NotImplementedError, match="A8\\(h\\)"):
        fleet.init(is_collective=True, strategy=s, backend="gloo")
