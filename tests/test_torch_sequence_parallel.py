"""The port's sequence parallelism and ring attention against the JAX
package's, on the CPU.

The reference is one process over 8 virtual devices; the port is one
process per rank. ONE world-4 launch of
``tests/_torch_sequence_parallel_worker.py`` through the port's launcher
(gloo, ``--devices cpu``) writes each rank's results to a temporary
directory while the reference runs here on the same numpy inputs. Held,
float32, atol 1e-5 / rtol 1e-4 (``ATOL``, ``RTOL``) unless a test says
otherwise:

- the sequence-parallel ops and linears at dp 2 x mp 2 (outputs and
  grads, shards gathered) against the reference's at mp 2. The
  reference's ops are sharding transitions that leave the tape (its
  ``_with_spec`` copies the input's node, none for a leaf: ROADMAP.md
  §C), so the grads are held to those of the functions they are, the
  identity for the ops and the reference's ``nn.Linear`` on the whole
  weights for the linears;
- ring attention at sep 4, at dp 2 x sep 2 and at sep 2 x mp 2 (the
  rank's heads), causal and not, against the reference's
  ``ring_attention(q, k, v, mesh, "sep", causal, head_axis=)``; heads
  that do not cut over mp record ``ring_head_replicated`` as the
  reference does;
- the tiny Llama at dp 2 x sep 2 under ``fleet.distributed_model``
  (``SegmentParallel``), the reference's at sep 2 with the same weights:
  the losses of three clipped AdamW steps, the first grads and the
  parameters after the steps.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as rpaddle
import paddle_tpu.distributed as rdist
import paddle_tpu.nn as rnn
from paddle_tpu import optimizer as RO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.distributed.fleet import sequence_parallel_utils as rsp
from paddle_tpu.models import LlamaConfig as RConfig
from paddle_tpu.models import LlamaForCausalLM as RModel
from paddle_tpu.models import LlamaPretrainingCriterion as RCrit
from paddle_tpu.observability import flight_recorder as rflight
from paddle_tpu.ops.kernels.pallas.ring_attention import \
    ring_attention as rring

from _torch_ref_state import reference_executables_dropped  # noqa: F401
from paddle_tpu_torch.distributed.launch import kill_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_sequence_parallel_worker.py")
LAUNCH_TIMEOUT_S = 150
CLIP = 0.05
ATOL, RTOL = 1e-5, 1e-4
RING = dict(b=2, s=32, hq=4, hk=2, d=8)
RING_REP = dict(b=1, s=16, hq=3, hk=1, d=8)     # 3 heads do not cut over 2


def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x, np.float32)


def _inputs():
    r = np.random.RandomState(0)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    inp = {"sp_x": f(2, 8, 8), "sp_ct": f(2, 8, 8), "col_w": f(8, 16),
           "col_b": f(16), "col_ct": f(2, 8, 16), "row_h": f(2, 8, 16),
           "row_w": f(16, 8), "row_b": f(8), "row_ct": f(2, 8, 8),
           "ids": r.randint(0, 256, (4, 64)).astype(np.int32),
           "clip": np.float32(CLIP)}
    for pre, c in (("ring", RING), ("ringr", RING_REP)):
        for name, h in (("q", c["hq"]), ("k", c["hk"]), ("v", c["hk"]),
                        ("ct", c["hq"])):
            inp[f"{pre}_{name}"] = f(c["b"], c["s"], h, c["d"]) * 0.5
    rpaddle.seed(0)
    model = RModel(RConfig.tiny())
    inp.update({f"llama/{k}": _np(v) for k, v in model.state_dict().items()})
    return inp


def _launch(out):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "4", "--devices", "cpu", "--max_restart", "0",
           "--log_dir", os.path.join(out, "log"), "--job_id", "sep",
           WORKER, out]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _strategy(**degrees):
    s = rdist.fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    return s


def _grad_of(fn, x, ct):
    """fn's output on the reference Tensor x and x's grad for ``ct``; an
    op whose output leaves the tape (a sharding transition) is the
    identity, whose grad is ``ct``."""
    xt = rpaddle.to_tensor(x, stop_gradient=False)
    y = fn(xt)
    (y * rpaddle.to_tensor(ct)).sum().backward()
    return _np(y), (ct if xt.grad is None else _np(xt.grad))


def _linear_reference(inp, pre, x, ct, sp_layer):
    """The SP layer's output, and the grads of the reference's plain
    ``nn.Linear`` on the same weights (its SP layer's function)."""
    w, b = (Tensor(jnp.asarray(inp[f"{pre}_{n}"])) for n in ("w", "b"))
    sp_layer.set_state_dict({"weight": w, "bias": b})
    y_sp = _np(sp_layer(rpaddle.to_tensor(x)))
    lin = rnn.Linear(*inp[f"{pre}_w"].shape)
    lin.set_state_dict({"weight": w, "bias": b})
    y, dx = _grad_of(lin, x, ct)
    np.testing.assert_allclose(y_sp, y, atol=ATOL, rtol=RTOL)
    return y, dx, _np(lin.weight.grad), _np(lin.bias.grad)


def _sp_reference(inp):
    rdist.fleet.init(is_collective=True, strategy=_strategy(mp=2))
    x, ct = inp["sp_x"], inp["sp_ct"]
    out = {}
    out["scatter"] = _grad_of(rsp.ScatterOp.apply, x, ct)
    out["gather"] = _grad_of(rsp.GatherOp.apply, x, ct)
    out["allgather"] = _grad_of(rsp.AllGatherOp.apply, x, ct)
    out["rs"] = _grad_of(rsp.ReduceScatterOp.apply, x, ct)
    out["col"] = _linear_reference(
        inp, "col", x, inp["col_ct"],
        rsp.ColumnSequenceParallelLinear(8, 16, has_bias=True))
    out["row"] = _linear_reference(
        inp, "row", inp["row_h"], inp["row_ct"],
        rsp.RowSequenceParallelLinear(16, 8, has_bias=True))
    return out


def _ring_reference(inp, pre, mesh, head_axis=None):
    q, k, v, ct = (jnp.asarray(inp[f"{pre}_{n}"]) for n in
                   ("q", "k", "v", "ct"))
    out = {}
    for causal in (False, True):
        y, vjp = jax.vjp(lambda a, b, c: rring(
            a, b, c, mesh, "sep", causal=causal, head_axis=head_axis),
            q, k, v)
        out[causal] = (np.asarray(y),) + tuple(
            np.asarray(g) for g in vjp(ct))
    return out


def _llama_reference(inp):
    rdist.fleet.init(is_collective=True, strategy=_strategy(sep=2))
    m = RModel(RConfig.tiny())
    m.set_state_dict({k[6:]: Tensor(jnp.asarray(v)) for k, v in inp.items()
                      if k.startswith("llama/")})
    net = rdist.fleet.distributed_model(m)
    opt = RO.AdamW(learning_rate=1e-3, weight_decay=0.01,
                   parameters=m.parameters(),
                   grad_clip=rnn.ClipGradByGlobalNorm(CLIP))
    ids = Tensor(jnp.asarray(inp["ids"]))
    losses, grads = [], None
    for _ in range(3):
        loss = RCrit()(net(ids), ids)
        loss.backward()
        if grads is None:
            grads = {n: _np(p.grad) for n, p in m.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss._data))
    return losses, grads, {n: _np(p) for n, p in m.named_parameters()}


def _replicated_keys(inp, mesh):
    rflight.recorder().clear()
    ref = _ring_reference(inp, "ringr", mesh, head_axis="mp")
    keys = sorted({e[5] for e in rflight.recorder().entries()
                   if str(e[3]).startswith("tp_attention.fallback")})
    return ref, keys


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sep"))
    saved = rtopo.get_hybrid_communicate_group()
    t0 = time.perf_counter()
    proc = _launch(out)     # the ranks import while the inputs are made
    try:
        inp = _inputs()
        np.savez(os.path.join(out, "inputs.tmp.npz"), **inp)
        os.replace(os.path.join(out, "inputs.tmp.npz"),
                   os.path.join(out, "inputs.npz"))
        devs = np.array(jax.devices()[:4])
        ref = {"sp": _sp_reference(inp)}
        rtopo.set_hybrid_communicate_group(None)
        ref["sep4"] = _ring_reference(inp, "ring", Mesh(devs, ("sep",)))
        ref["sep2"] = _ring_reference(inp, "ring", Mesh(devs[:2], ("sep",)))
        sepmp = Mesh(devs.reshape(2, 2), ("sep", "mp"))
        ref["sepmp"] = _ring_reference(inp, "ring", sepmp, head_axis="mp")
        ref["sepmp_rep"], ref["rep_keys"] = _replicated_keys(inp, sepmp)
        ref["llama"] = _llama_reference(inp)
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        kill_group(proc)
        rtopo.set_hybrid_communicate_group(saved)
    assert proc.returncode == 0, log[-4000:]
    ranks = [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
              json.load(open(os.path.join(out, f"rank{r}.json"))))
             for r in range(4)]
    print(f"sequence parallel: {time.perf_counter() - t0:.1f} s")
    return inp, ref, ranks


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _cat(ranks, key, order, dim):
    return np.concatenate([ranks[r][0][key] for r in order], axis=dim)


# -- the sequence-parallel ops and linears (dp 2 x mp 2) ----------------------

@pytest.mark.parametrize("op", ["scatter", "gather", "allgather", "rs"])
def test_sp_op_matches_reference(run, op):
    _, ref, ranks = run
    y, dx = ref["sp"][op]
    for r, (res, _) in enumerate(ranks):
        mp = r % 2
        if op in ("scatter", "rs"):       # out cut on seq, grad whole
            _close(res[f"{op}_y"], np.split(y, 2, 1)[mp])
            _close(res[f"{op}_dx"], dx)
        else:                             # out whole, grad cut on seq
            _close(res[f"{op}_y"], y)
            _close(res[f"{op}_dx"], np.split(dx, 2, 1)[mp])


def test_column_sequence_parallel_linear_matches_reference(run):
    _, ref, ranks = run
    y, dx, dw, db = ref["sp"]["col"]
    for r, (res, _) in enumerate(ranks):
        mp = r % 2
        _close(res["col_y"], np.split(y, 2, 2)[mp])
        _close(res["col_dx"], np.split(dx, 2, 1)[mp])
    _close(_cat(ranks, "col_dw", (0, 1), 1), dw)
    _close(_cat(ranks, "col_db", (0, 1), 0), db)


def test_row_sequence_parallel_linear_and_hooks_match_reference(run):
    _, ref, ranks = run
    y, dh, dw, db = ref["sp"]["row"]
    for r, (res, meta) in enumerate(ranks):
        mp = r % 2
        assert meta["sp_bias_marked"]
        _close(res["row_y"], np.split(y, 2, 1)[mp])
        _close(res["row_dh"], np.split(dh, 2, 2)[mp])
        _close(res["row_db"], db)        # summed over mp by the hook
    _close(_cat(ranks, "row_dw", (0, 1), 0), dw)


# -- ring attention -----------------------------------------------------------

def _ring_close(ranks, tag, want, order, heads=False):
    for causal in (False, True):
        key = f"{tag}_{'causal' if causal else 'full'}"
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            if heads:      # sep 2 x mp 2: rank = sep * 2 + mp
                got = np.concatenate([
                    np.concatenate([ranks[2 * s + m][0][f"{key}_{name}"]
                                    for m in (0, 1)], axis=2)
                    for s in (0, 1)], axis=1)
            else:
                got = _cat(ranks, f"{key}_{name}", order, 1)
            _close(got, want[causal][i])


def test_ring_sep4_matches_reference(run):
    _, ref, ranks = run
    assert [m["sep4"] for _, m in ranks] == [[4, r] for r in range(4)]
    _ring_close(ranks, "sep4", ref["sep4"], (0, 1, 2, 3))


@pytest.mark.parametrize("dp", [0, 1])
def test_ring_dp2_sep2_matches_reference(run, dp):
    _, ref, ranks = run
    assert ranks[2 * dp][1]["sep2"] == [2, 0]
    _ring_close(ranks, "sep2", ref["sep2"], (2 * dp, 2 * dp + 1))


def test_ring_sep2_mp2_on_local_heads_matches_reference(run):
    _, ref, ranks = run
    _ring_close(ranks, "sepmp", ref["sepmp"], None, heads=True)
    for _, meta in ranks:
        assert meta["sepmp_counters"]["sharded"] == 2     # full and causal
        assert meta["sepmp_counters"]["fallback"] == 0


def test_ring_heads_that_do_not_cut_record_the_reference_key(run):
    _, ref, ranks = run
    assert ref["rep_keys"] == ["ring_head_replicated"]
    for r, (_, meta) in enumerate(ranks):
        assert meta["replicated_keys"] == ["ring_head_replicated"]
    # every mp rank holds every head of its sequence chunk
    for m in (0, 1):
        _ring_close(ranks, "sepmp_rep", ref["sepmp_rep"], (m, 2 + m))


# -- the tiny Llama under SegmentParallel (dp 2 x sep 2) ----------------------

def test_llama_sep_losses_match_reference(run):
    _, ref, ranks = run
    losses = ref["llama"][0]
    for _, meta in ranks:
        assert meta["sep_wrapper"] == "SegmentParallel"
        np.testing.assert_allclose(meta["llama_losses"], losses, atol=ATOL,
                                   rtol=RTOL)


def test_llama_sep_grads_match_reference(run):
    _, ref, ranks = run
    want = ref["llama"][1]
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in want.values()))
    assert norm > CLIP                    # the clip acts in the steps
    for res, _ in ranks:
        for name, g in want.items():
            _close(res[f"grad/{name}"], g)


def test_llama_sep_params_after_three_steps_match_reference(run):
    _, ref, ranks = run
    for res, _ in ranks:
        for name, p in ref["llama"][2].items():
            _close(res[f"param/{name}"], p)
