"""The port's expert parallelism against the JAX package's, on the CPU.

ONE world-4 launch of ``tests/_torch_expert_parallel_worker.py`` through
the port's launcher (gloo, ``--devices cpu``, dp 4, ``expert_axis="dp"``)
writes each rank's results to a temporary directory while the reference
runs here on the same numpy inputs. The reference's contract
(``tests/test_moe.py:171``, ``test_ep_matches_local``) is that expert
parallelism equals the single-shard path run on each token shard with
the shard's own capacity; so each rank's results are held to the
reference's ``_moe_local`` on that rank's tokens, and the grads of an
expert to the sum (the model's: the mean) over the shards of the
reference's. Held, float32, atol 1e-5 / rtol 1e-4 (``ATOL``, ``RTOL``):

- ``moe_ffn`` through ``call_op`` with every expert's weights, and a
  ``MoELayer`` holding its rank's 2 of 8 experts: outputs, the load-
  balance loss (averaged over the ranks, as the reference's ``pmean``),
  input and weight grads;
- the fallbacks (the reference's :181-185, ``tests/test_moe.py:205``):
  token counts that differ over the ranks, and 6 experts over 4 ranks,
  run every expert locally and are counted;
- the tiny MoE model at dp 4: the losses of three AdamW steps with an
  active global-norm clip, the first grads (dense ones averaged by
  ``DataParallel``, the experts' summed by the all-to-alls and scaled)
  and the parameters after the steps, against the reference model trained
  on the mean of the four shards' losses.
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

import paddle_tpu as rpaddle
import paddle_tpu.nn as rnn
from paddle_tpu import optimizer as RO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import topology as rtopo
from paddle_tpu.models.moe import MoEConfig as RMoEConfig
from paddle_tpu.models.moe import MoEForCausalLM as RMoE
from paddle_tpu.models.moe import MoEPretrainingCriterion as RMoECrit
from paddle_tpu.ops.kernels.moe import _moe_local

from paddle_tpu_torch.distributed.launch import kill_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_expert_parallel_worker.py")
LAUNCH_TIMEOUT_S = 150
CLIP = 0.05
ATOL, RTOL = 1e-5, 1e-4


def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x, np.float32)


def _inputs():
    r = np.random.RandomState(0)
    f = lambda *s, scale=0.3: (r.randn(*s) * scale).astype(np.float32)  # noqa
    h, m, E = 8, 16, 8
    inp = {"x": f(16, h, scale=1.0), "ct": f(16, h, scale=1.0),
           "gw": f(h, E, scale=1.0), "gp": f(E, h, m), "up": f(E, h, m),
           "dp": f(E, m, h), "gw6": f(h, 6, scale=1.0), "gp6": f(6, h, m),
           "up6": f(6, h, m), "dp6": f(6, m, h),
           "ids": r.randint(0, 256, (4, 16)).astype(np.int32),
           "clip": np.float32(CLIP)}
    rpaddle.seed(0)
    model = RMoE(RMoEConfig.tiny_moe(num_experts=8))
    inp.update({f"moe/{k}": _np(v) for k, v in model.state_dict().items()})
    return inp, model


def _launch(out):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "4", "--devices", "cpu", "--max_restart", "0",
           "--log_dir", os.path.join(out, "log"), "--job_id", "ep",
           WORKER, out]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _local(x, ws, ct):
    """The reference's single-shard path: out, aux and the grads of
    ``sum(out * ct)`` in x and the four weights."""
    def f(x, gw, gp, up, dp):
        return _moe_local(x, gw, gp, up, dp, 2, 1.25, False)
    (out, aux), vjp = jax.vjp(f, jnp.asarray(x),
                              *(jnp.asarray(w) for w in ws))
    grads = vjp((jnp.asarray(ct), jnp.zeros_like(aux)))
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


def _moe_reference(inp, model):
    """Three clipped AdamW steps on the mean of the four shards' losses."""
    cfg = RMoEConfig.tiny_moe(num_experts=8)
    opt = RO.AdamW(learning_rate=1e-3, weight_decay=0.01,
                   parameters=model.parameters(),
                   grad_clip=rnn.ClipGradByGlobalNorm(CLIP))
    crit = RMoECrit(cfg, model)
    losses, grads = [], None
    for _ in range(3):
        total = None
        for r in range(4):
            ids = Tensor(jnp.asarray(inp["ids"][r:r + 1]))
            loss = crit(model(ids), ids) / 4.0
            total = loss if total is None else total + loss
        total.backward()
        if grads is None:
            grads = {n: _np(p.grad) for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(total._data))
    return losses, grads, {n: _np(p) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ep"))
    saved = rtopo.get_hybrid_communicate_group()
    rtopo.set_hybrid_communicate_group(None)
    t0 = time.perf_counter()
    proc = _launch(out)
    try:
        inp, model = _inputs()
        np.savez(os.path.join(out, "inputs.tmp.npz"), **inp)
        os.replace(os.path.join(out, "inputs.tmp.npz"),
                   os.path.join(out, "inputs.npz"))
        ws = [inp[n] for n in ("gw", "gp", "up", "dp")]
        ref = {"shards": [_local(inp["x"][4 * r:4 * r + 4], ws,
                                 inp["ct"][4 * r:4 * r + 4])
                          for r in range(4)]}
        ref["ragged"] = [_local(inp["x"][:3 + r], ws,
                                np.ones((3 + r, 8), np.float32))
                         for r in range(4)]
        ws6 = [inp[n] for n in ("gw6", "gp6", "up6", "dp6")]
        ref["e6"] = [_local(inp["x"][4 * r:4 * r + 4], ws6,
                            np.zeros((4, 8), np.float32))[0]
                     for r in range(4)]
        ref["moe"] = _moe_reference(inp, model)
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        kill_group(proc)
        rtopo.set_hybrid_communicate_group(saved)
    assert proc.returncode == 0, log[-4000:]
    ranks = [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
              json.load(open(os.path.join(out, f"rank{r}.json"))))
             for r in range(4)]
    print(f"expert parallel: {time.perf_counter() - t0:.1f} s")
    return inp, ref, ranks


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_moe_ffn_op_matches_per_shard_local(run):
    _, ref, ranks = run
    shards = ref["shards"]
    aux = np.mean([s[1] for s in shards])
    for r, (res, meta) in enumerate(ranks):
        out, _, grads = shards[r]
        assert meta["ep_calls"] == 1
        _close(res["op_out"], out)
        _close(res["op_aux"], aux)
        _close(res["op_dx"], grads[0])
        _close(res["op_dgw"], grads[1])      # the gate: this shard's
        for i, n in enumerate(("gp", "up", "dp")):
            mine = res[f"op_d{n}"]
            want = sum(s[2][i + 2] for s in shards)  # every shard's tokens
            _close(mine[2 * r:2 * r + 2], want[2 * r:2 * r + 2])
            others = np.delete(mine, [2 * r, 2 * r + 1], axis=0)
            assert not others.any()                 # not this rank's


def test_moe_layer_holds_its_experts_and_matches(run):
    _, ref, ranks = run
    shards = ref["shards"]
    for r, (res, meta) in enumerate(ranks):
        assert meta["layer_local_experts"] == 2
        assert meta["layer_marks"] == [True, True]
        _close(res["layer_out"][0], shards[r][0])
        _close(res["layer_dx"][0], shards[r][2][0])
        for i, n in enumerate(("gp", "up", "dp")):
            want = sum(s[2][i + 2] for s in shards)[2 * r:2 * r + 2]
            _close(res[f"layer_d{n}"], want)


def test_ragged_token_counts_fall_back_to_local(run):
    _, ref, ranks = run
    for r, (res, meta) in enumerate(ranks):
        assert meta["ragged_fallbacks"] == 1
        _close(res["ragged_out"][0], ref["ragged"][r][0])
        want = sum(s[2][2] for s in ref["ragged"])[2 * r:2 * r + 2]
        _close(res["ragged_dgp"], want)     # reduce-scattered back


def test_experts_that_do_not_divide_stay_whole(run):
    _, ref, ranks = run
    for r, (res, meta) in enumerate(ranks):
        assert meta["e6_local_experts"] == 6
        assert meta["e6_fallbacks"] == 1
        _close(res["e6_out"][0], ref["e6"][r])


def test_moe_model_losses_match_reference(run):
    _, ref, ranks = run
    for _, meta in ranks:
        assert meta["clip"] == "HybridParallelClipGrad"
        np.testing.assert_allclose(meta["moe_losses"], ref["moe"][0],
                                   atol=ATOL, rtol=RTOL)


def _expert_rows(name, r):
    return ".experts." in name and name.endswith("_weight") and \
        ".gate." not in name


@pytest.mark.parametrize("what", ["grad", "param"])
def test_moe_model_grads_and_params_match_reference(run, what):
    _, ref, ranks = run
    want = ref["moe"][1 if what == "grad" else 2]
    if what == "grad":
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in want.values()))
        assert norm > CLIP                 # the clip acts in the steps
    for r, (res, _) in enumerate(ranks):
        for name, w in want.items():
            if _expert_rows(name, r):
                w = w[2 * r:2 * r + 2]
            _close(res[f"{what}/{name}"], w)


def test_moe_model_checks_token_counts_once_a_forward(run):
    """The model's forward checks the ranks' token counts with one
    all-reduce for all its MoE layers, which take the answer."""
    _, _, ranks = run
    for _, meta in ranks:
        assert meta["moe_layers"] > 1
        assert meta["token_checks_first_forward"] == 1
