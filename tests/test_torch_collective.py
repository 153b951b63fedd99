"""The port's collectives against the JAX package's, on the CPU.

The port side runs once for the file: ONE world-4 launch of
``tests/_torch_collective_worker.py`` through the port's launcher
(``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4
--devices cpu``, gloo), which also exercises the launcher and the
variables it sets; each rank writes its results to a temporary
directory. ``distributed.spawn`` starts two more processes beside it. The reference side runs here, on its 8 virtual devices: each
rank's input is a shard of one global array over a 4-device mesh axis.
Held: float32 reductions within 1e-6 relative, gathers, broadcasts, max
and min exactly.

Where the reference's single controller degenerates, the port is held to
Paddle's per-rank semantics, and ROADMAP.md §C records the difference:
``broadcast`` (the reference keeps the global tensor), ``scatter`` (it
takes the first slice of the concatenation, ``collective.py:274-278``),
``all_gather_object`` (world-size copies of the caller's object,
``:495-500``); its PROD all-reduce raises under JAX's replication check,
so PROD is held to numpy. P2P, the store and the watchdog have no
reference computation to compare (its P2P is an in-process queue): they
are held to their contracts.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as rpaddle
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed import collective as RC
from paddle_tpu.ops.dispatcher import call_op as rcall_op
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.launch import kill_group

from _torch_collective_worker import (LATE_S, N, OPS, TIMEOUT_S, rank_inputs,
                                      spawn_probe)
from _torch_ref_state import reference_executables_dropped  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_collective_worker.py")
LAUNCH_TIMEOUT_S = 120
RTOL = 1e-6


def _launch(out, nproc=N, script=WORKER, extra=()):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--devices", "cpu",
           "--max_restart", "0", "--log_dir", os.path.join(out, "log"),
           "--job_id", "coll", *extra, script, out]
    # a session of its own: the launcher and its ranks are one group
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _ref(fn):
    """``fn(sharded, group)`` on the reference: the ranks' inputs as the
    4 shards (dim 0) of one global array over a 4-device mesh axis."""
    mesh = rdist.ProcessMesh(np.arange(N), ["x"])

    def sharded(key):
        glob = np.concatenate([rank_inputs(r)[key] for r in range(N)])
        return rdist.shard_tensor(rpaddle.to_tensor(glob), mesh,
                                  [rdist.Shard(0)])
    return fn(sharded, RC.Group("x", N))


def _reference():
    out = {}
    for op in ("sum", "max", "min", "avg"):
        def red(sh, g, op=op):
            t = sh("x")
            RC.all_reduce(t, op=op, group=g)
            return np.asarray(t._data)
        out[f"all_reduce_{op}"] = _ref(red)
    out["all_gather"] = _ref(lambda sh, g: np.stack(
        [np.asarray(t._data) for t in RC.all_gather([], sh("x"), group=g)]))
    for name in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min"):
        out[name] = _ref(lambda sh, g, name=name: np.asarray(
            rcall_op(name, sh("x"))._data))
    # all_to_all: the reference's input i is rank i's chunks, whole
    ins = [rpaddle.to_tensor(rank_inputs(r)["chunks"].reshape(N, 2))
           for r in range(N)]
    out["all_to_all"] = np.stack([np.asarray(t._data)
                                  for t in RC.all_to_all([], ins)])
    for op in ("sum", "max", "avg"):
        t = rpaddle.to_tensor(np.zeros((2 * N, 3), np.float32))
        RC.reduce_scatter(t, [rpaddle.to_tensor(rank_inputs(r)["full"])
                              for r in range(N)], op=op)
        out[f"reduce_scatter_{op}"] = np.asarray(t._data)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collective"))
    t0 = time.perf_counter()
    proc = _launch(out)
    spawned = spawn(spawn_probe, args=(out,), nprocs=2, join=False)
    try:
        ref = _reference()
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
        deadline = time.monotonic() + LAUNCH_TIMEOUT_S
        while not spawned.join(timeout=1):
            assert time.monotonic() < deadline, "spawn: no end"
    finally:
        kill_group(proc)
        for p in spawned.processes:
            if p.is_alive():
                p.kill()
    assert proc.returncode == 0, log[-4000:]
    ranks = [(dict(np.load(os.path.join(out, f"rank{r}.npz"))),
              json.load(open(os.path.join(out, f"rank{r}.json"))))
             for r in range(N)]
    seen = [json.load(open(os.path.join(out, f"spawn{r}.json")))
            for r in range(2)]
    print(f"collectives: {time.perf_counter() - t0:.1f} s")
    return ref, ranks, seen


def _ins(key):
    return [rank_inputs(r)[key] for r in range(N)]


def test_launcher_set_each_ranks_variables(run):
    _, ranks, _ = run
    ports = set()
    for r, (_, meta) in enumerate(ranks):
        e = meta["env"]
        assert e["PADDLE_TRAINER_ID"] == e["RANK"] == str(r)
        assert e["PADDLE_TRAINERS_NUM"] == e["WORLD_SIZE"] == str(N)
        assert e["PADDLE_LOCAL_RANK"] == e["LOCAL_RANK"] == str(r)
        assert e["PADDLE_DEVICES"] == "cpu" and e["PADDLE_JOB_ID"] == "coll"
        assert e["PADDLE_STORE_HOSTED"] == "1"
        ports.add(e["MASTER_PORT"])
        assert meta["rank"] == [r, N, r, r, N, "gloo", "cpu"]
    assert len(ports) == 1


@pytest.mark.parametrize("op", OPS)
def test_all_reduce_each_op(run, op):
    ref, ranks, _ = run
    if op == "prod":    # the reference's PROD raises (module docstring)
        want = np.prod(np.stack(_ins("x")), axis=0)
    else:
        want = ref[f"all_reduce_{op}"]
    for res, _ in ranks:
        got = res[f"all_reduce_{op}"]
        if op in ("max", "min"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_all_reduce_int_is_exact(run):
    _, ranks, _ = run
    want = np.sum(np.stack(_ins("i")), axis=0)
    for res, _ in ranks:
        np.testing.assert_array_equal(res["all_reduce_int"], want)


def test_all_gather_and_broadcast(run):
    ref, ranks, _ = run
    for res, _ in ranks:
        np.testing.assert_array_equal(res["all_gather"], ref["all_gather"])
        np.testing.assert_array_equal(res["broadcast"], _ins("x")[2])


@pytest.mark.parametrize("op", ["sum", "max"])
def test_reduce_lands_on_dst_only(run, op):
    ref, ranks, _ = run
    for r, (res, _) in enumerate(ranks):
        if r == 1:
            np.testing.assert_allclose(res[f"reduce_{op}"],
                                       ref[f"all_reduce_{op}"], rtol=RTOL)
        else:
            np.testing.assert_array_equal(res[f"reduce_{op}"], _ins("x")[r])


def test_scatter_gives_rank_i_the_ith_tensor(run):
    _, ranks, _ = run
    for r, (res, _) in enumerate(ranks):
        np.testing.assert_array_equal(res["scatter"],
                                      rank_inputs(3)["chunks"][r])


def test_all_to_all_matches_reference_transpose(run):
    ref, ranks, _ = run
    for j, (res, _) in enumerate(ranks):
        np.testing.assert_array_equal(res["all_to_all"].reshape(N, 2),
                                      ref["all_to_all"][j])


@pytest.mark.parametrize("op", ["sum", "max", "avg"])
def test_reduce_scatter_list_form(run, op):
    ref, ranks, _ = run
    got = np.concatenate([res[f"reduce_scatter_list_{op}"]
                          for res, _ in ranks])
    np.testing.assert_allclose(got, ref[f"reduce_scatter_{op}"], rtol=RTOL)


def test_reduce_scatter_tensor_form(run):
    ref, ranks, _ = run
    got = np.concatenate([res["reduce_scatter_tensor"] for res, _ in ranks])
    np.testing.assert_allclose(got, ref["reduce_scatter_sum"], rtol=RTOL)


def test_subgroup_all_reduce(run):
    _, ranks, _ = run
    want = _ins("x")[0] + _ins("x")[2]
    for r, (res, meta) in enumerate(ranks):
        if r in (0, 2):
            np.testing.assert_allclose(res["group_02_sum"], want, rtol=RTOL)
            assert meta["group_02"] == [r // 2, 2, [0, 2]]
        else:       # outside the group: left as it was
            np.testing.assert_array_equal(res["group_02_sum"], _ins("x")[r])
            assert meta["group_02"][0] == -1


@pytest.mark.parametrize("kind,scale", [("ring_sync", 1), ("ring_async", 2),
                                        ("ring_batch", 3)])
def test_p2p_ring(run, kind, scale):
    _, ranks, _ = run
    for r, (res, _) in enumerate(ranks):
        np.testing.assert_array_equal(res[kind],
                                      _ins("x")[(r - 1) % N] * scale)


def test_object_collectives_are_per_rank(run):
    _, ranks, _ = run
    want = [{"rank": r, "tag": "x" * r} for r in range(N)]
    for r, (_, meta) in enumerate(ranks):
        assert meta["all_gather_object"] == want
        assert meta["scatter_object_list"] == [{"to": r, "from": 1}]
    # the reference's single controller: copies of the caller's object
    objs = []
    RC.all_gather_object(objs, {"rank": 0})
    assert objs == [{"rank": 0}] * rdist.get_world_size()


@pytest.mark.parametrize("name", ["c_allreduce_sum", "c_allreduce_max",
                                  "c_allreduce_min", "c_allreduce_prod",
                                  "c_broadcast"])
def test_registry_collective_entries(run, name):
    ref, ranks, _ = run
    if name == "c_allreduce_prod":
        want = np.prod(np.stack(_ins("x")), axis=0)
    elif name == "c_broadcast":
        want = _ins("x")[2]
    else:
        want = ref[name]
    for res, _ in ranks:
        np.testing.assert_allclose(res[name], want, rtol=RTOL, atol=0)


def test_store_set_get_add_wait_barrier(run):
    _, ranks, _ = run
    adds = sorted(meta["store_add"] for _, meta in ranks)
    assert adds[-1] == 10 and len(set(adds)) == N   # atomic increments
    for _, meta in ranks:
        assert meta["store_get"] == "hello"
        assert meta["store_total"] == 10
        assert meta["store_wait"] == 0
        assert meta["store_wait_missing"] == -1
        assert meta["store_get_nowait"] is None
        assert meta["staged"] == 0          # CPU tensors: nothing staged
        assert meta["calls"] >= 30


def test_watchdog_fires_on_a_late_rank(run):
    _, ranks, _ = run
    for r, (res, meta) in enumerate(ranks):
        np.testing.assert_allclose(res["watched_sum"],
                                   np.sum(np.stack(_ins("x")), axis=0),
                                   rtol=RTOL)
        if r == 3:
            assert meta["fired"] == [] and meta["timed_out"] == []
            continue
        assert meta["watched_s"] > LATE_S - 0.5
        assert [(n, k) for n, k, _ in meta["fired"]] == \
            [("eager:all_reduce", r)]
        assert meta["fired"][0][2] >= TIMEOUT_S
        assert meta["timed_out"] == ["eager:all_reduce"]
    published = ranks[0][1]["published"]
    assert all(p.startswith("timeout after") for p in published[:3])
    assert published[3] == ""


def test_a_failing_rank_fails_the_launch_with_its_log(tmp_path):
    from paddle_tpu_torch.distributed.launch import launch
    script = tmp_path / "fail.py"
    script.write_text("import os, sys\nprint('rank', "
                      "os.environ['PADDLE_TRAINER_ID'], 'failing')\n"
                      "sys.exit(3 if os.environ['RANK'] == '1' else 0)\n")
    rc = launch(["--nproc_per_node", "2", "--max_restart", "1",
                 "--log_dir", str(tmp_path / "log"), str(script)])
    assert rc == 1
    assert (tmp_path / "log" / "default.0.1.log").read_text() == \
        "rank 1 failing\n"


def test_sigterm_to_the_launcher_stops_its_ranks(tmp_path):
    from paddle_tpu_torch.distributed.launch import launch
    script = tmp_path / "wait.py"
    script.write_text("import os, sys, time\n"
                      "p = sys.argv[1] + os.environ['RANK']\n"
                      "open(p + '.tmp', 'w').write(str(os.getpid()))\n"
                      "os.replace(p + '.tmp', p)\n"
                      "time.sleep(30)\n")
    pids = [tmp_path / f"pid{r}" for r in range(2)]
    returned = threading.Event()

    def term():                 # once both ranks run, SIGTERM this process
        deadline = time.monotonic() + 20
        while not all(p.exists() for p in pids):
            if returned.is_set() or time.monotonic() > deadline:
                return
            time.sleep(0.05)
        if not returned.is_set():
            os.kill(os.getpid(), signal.SIGTERM)

    killer = threading.Thread(target=term, daemon=True)
    killer.start()
    try:
        rc = launch(["--nproc_per_node", "2", "--log_dir",
                     str(tmp_path / "log"), str(script),
                     str(tmp_path / "pid")])
    finally:
        returned.set()
        killer.join(timeout=25)
    assert rc == 143
    for p in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(int(p.read_text()), 0)


class _Event:
    """A stand-in for ``torch.cuda.Event``: done when ``done`` is set."""
    done = threading.Event()

    def record(self):
        pass

    def query(self):
        return self.done.is_set()


@pytest.mark.parametrize("settles", [True, False])
def test_watchdog_holds_nccl_tasks_until_the_card_passes(monkeypatch,
                                                          settles):
    """Under NCCL a call returns once queued: its task stays open until
    the event behind it is passed, and times out if it never is."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager
    monkeypatch.setattr(C._S, "backend", "nccl")
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.done = threading.Event()
    mgr = CommTaskManager(scan_interval=0.02)
    fired = []
    mgr.add_handler(lambda t: fired.append(t.name))
    task = mgr.start_task("eager:all_reduce", timeout_s=0.4)
    try:
        C._settle(task)
        time.sleep(0.1)
        assert not task.done and not fired      # queued, not passed
        if settles:
            _Event.done.set()
        deadline = time.monotonic() + 5
        while not (task.done or fired):
            assert time.monotonic() < deadline, "the scan never ended it"
            time.sleep(0.02)
        time.sleep(0.5)                         # past the timeout
    finally:
        mgr.shutdown()
    if settles:
        assert task.done and fired == [] and mgr.timed_out_tasks() == []
    else:
        assert fired == ["eager:all_reduce"]
        assert mgr.timed_out_tasks() == [task]


def test_spawn_started_real_processes(run):
    seen = run[2]
    assert [(s["world"], s["sum"]) for s in seen] == [(2, 3.0)] * 2
    assert len({s["pid"] for s in seen} | {os.getpid()}) == 3


def test_nccl_on_a_shared_card_raises(monkeypatch):
    from paddle_tpu_torch.distributed.collective import resolve_device
    with pytest.raises(ValueError, match="backend='gloo'"):
        resolve_device("nccl")          # no card here at all
    monkeypatch.setenv("PADDLE_DEVICES", "0,0")
    with pytest.raises(ValueError, match="backend='gloo'"):
        resolve_device("nccl")
    monkeypatch.setenv("PADDLE_DEVICES", "cpu")
    assert str(resolve_device("gloo")) == "cpu"


def test_elastic_levels_and_many_nodes_raise():
    from paddle_tpu_torch.distributed.launch.context import parse_args
    with pytest.raises(NotImplementedError, match="A8"):
        parse_args(["--elastic_level", "0", "x.py"])
    with pytest.raises(NotImplementedError, match="A8"):
        parse_args(["--nnodes", "2", "x.py"])
