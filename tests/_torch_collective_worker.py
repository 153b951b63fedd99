"""One rank of ``tests/test_torch_collective.py``'s world-4 launch.

Started by ``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 4 --devices cpu tests/_torch_collective_worker.py DIR``:
joins over gloo, runs every collective of ``distributed.collective`` on
this rank's seeded inputs (:func:`rank_inputs`, which the test imports
to compute the reference's side), the object collectives, the five
``c_*`` registry entries, P2P and ``batch_isend_irecv``, the job store,
and the watchdog (rank 3 reaches an all-reduce 2 s late under a 1 s
``comm_timeout_s``); then writes ``DIR/rank<r>.npz`` and
``DIR/rank<r>.json``. Only the port is imported here (no JAX).
"""

import json
import os
import sys
import time

import numpy as np

N = 4
OPS = ("sum", "max", "min", "prod", "avg")
LATE_S = 2.0          # how late rank 3 reaches the watched all-reduce
TIMEOUT_S = 1.0       # FLAGS_comm_timeout_s there


def rank_inputs(r: int) -> dict:
    """Rank r's inputs: positive float32 (PROD stays finite), int64."""
    rng = np.random.RandomState(100 + r)
    return {"x": (rng.rand(3, 2) + 0.5).astype(np.float32),
            "i": rng.randint(-50, 50, (5,)).astype(np.int64),
            "chunks": (rng.rand(N, 1, 2) + 0.5).astype(np.float32),
            "full": (rng.rand(N * 2, 3) + 0.5).astype(np.float32)}


def spawn_probe(out: str) -> None:
    """A ``distributed.spawn`` process: join over gloo, all-reduce the
    rank, write what it saw."""
    import torch

    from paddle_tpu_torch.distributed import collective as C
    C.init_parallel_env(backend="gloo")
    t = torch.tensor([float(C.get_rank() + 1)])
    C.all_reduce(t)
    with open(os.path.join(out, f"spawn{C.get_rank()}.json"), "w") as f:
        json.dump({"world": C.get_world_size(), "sum": float(t),
                   "pid": os.getpid()}, f)
    C.destroy_process_group()


def main(out: str) -> None:
    import torch

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env, watchdog
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops.dispatcher import call_op

    torch.set_num_threads(1)
    pe = C.init_parallel_env(backend="gloo")
    r = C.get_rank()
    mine = {k: torch.from_numpy(v) for k, v in rank_inputs(r).items()}
    res, meta = {}, {}
    reg = metrics.registry()
    calls0 = reg.get("distributed.collective_calls").value
    meta["env"] = {k: os.environ.get(k) for k in (
        "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "PADDLE_DEVICES",
        "PADDLE_STORE_HOSTED", "PADDLE_JOB_ID", "MASTER_PORT")}
    meta["rank"] = [env.get_rank(), env.get_world_size(),
                    env.get_local_rank(), pe.rank, pe.world_size,
                    C.get_backend(), str(pe.device)]

    for op in OPS:
        t = mine["x"].clone()
        C.all_reduce(t, op=op)
        res[f"all_reduce_{op}"] = t.numpy()
    t = mine["i"].clone()
    C.all_reduce(t)
    res["all_reduce_int"] = t.numpy()
    res["all_gather"] = torch.stack(C.all_gather([], mine["x"])).numpy()
    t = mine["x"].clone()
    C.broadcast(t, src=2)
    res["broadcast"] = t.numpy()
    for op in ("sum", "max"):
        t = mine["x"].clone()
        C.reduce(t, dst=1, op=op)
        res[f"reduce_{op}"] = t.numpy()
    t = torch.empty(1, 2)
    C.scatter(t, list(mine["chunks"]) if r == 3 else None, src=3)
    res["scatter"] = t.numpy()
    res["all_to_all"] = torch.stack(
        C.all_to_all([], list(mine["chunks"]))).numpy()
    for op in ("sum", "max", "avg"):
        t = torch.empty(2, 3)
        C.reduce_scatter(t, list(mine["full"].split(2)), op=op)
        res[f"reduce_scatter_list_{op}"] = t.numpy()
    t = torch.empty(2, 3)
    C.reduce_scatter(t, mine["full"])
    res["reduce_scatter_tensor"] = t.numpy()
    pair = C.new_group([0, 2])
    t = mine["x"].clone()
    C.all_reduce(t, group=pair)
    res["group_02_sum"] = t.numpy()
    meta["group_02"] = [pair.rank, pair.nranks, pair.ranks]

    # P2P: a ring, sync (even ranks send first), async, batched
    nxt, prv = (r + 1) % N, (r - 1) % N
    got = torch.empty(3, 2)
    if r % 2 == 0:
        C.send(mine["x"], dst=nxt)
        C.recv(got, src=prv)
    else:
        C.recv(got, src=prv)
        C.send(mine["x"], dst=nxt)
    res["ring_sync"] = got.numpy()
    got = torch.empty(3, 2)
    works = [C.isend(mine["x"] * 2, dst=nxt), C.irecv(got, src=prv)]
    for w in works:
        w.wait()
    res["ring_async"] = got.numpy()
    got = torch.empty(3, 2)
    works = C.batch_isend_irecv([C.P2POp(C.isend, mine["x"] * 3, nxt),
                                 C.P2POp(C.irecv, got, prv)])
    for w in works:
        w.wait()
    res["ring_batch"] = got.numpy()

    objs = C.all_gather_object([], {"rank": r, "tag": "x" * r})
    meta["all_gather_object"] = objs
    got = C.scatter_object_list(
        [], [{"to": i, "from": 1} for i in range(N)] if r == 1 else None,
        src=1)
    meta["scatter_object_list"] = got

    for name in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
                 "c_allreduce_prod"):
        x = mine["x"].clone()
        res[name] = call_op(name, x).numpy()
        assert torch.equal(x, mine["x"])        # the op leaves x as it was
    res["c_broadcast"] = call_op("c_broadcast", mine["x"], root=2).numpy()

    store = C.get_store()
    if r == 0:
        store.set("greeting", b"hello")
    meta["store_get"] = store.get("greeting").decode()
    meta["store_add"] = store.add("count", r + 1)
    store.barrier("after_add")
    meta["store_total"] = store.add("count", 0)
    if r == 3:
        time.sleep(0.2)
        store.set("late_key", "set by rank 3")
    meta["store_wait"] = store.wait("late_key", 10_000)
    meta["store_wait_missing"] = store.wait("never_set", 100)
    meta["store_get_nowait"] = store.get("never_set", wait=False)
    for _ in range(2):
        store.barrier("twice")
    meta["calls"] = reg.get("distributed.collective_calls").value - calls0
    meta["staged"] = reg.get("distributed.host_staged_bytes").value

    # the watchdog: rank 3 is late; the others' task outlives the timeout
    fired = []
    prev = flags.get_flag("comm_timeout_s")
    flags.set_flags({"comm_timeout_s": TIMEOUT_S})
    try:
        watchdog.comm_watchdog().add_handler(lambda task: fired.append(
            (task.name, task.rank, round(task.elapsed(), 3))))
        C.barrier()
        if r == 3:
            time.sleep(LATE_S)
        t0 = time.monotonic()
        t = mine["x"].clone()
        C.all_reduce(t)
        meta["watched_s"] = time.monotonic() - t0
    finally:
        flags.set_flags({"comm_timeout_s": prev})
    meta["fired"] = fired
    meta["timed_out"] = [tk.name for tk in
                         watchdog.comm_watchdog().timed_out_tasks()]
    C.barrier()
    meta["published"] = [
        (store.get(f"comm_error/{i}/eager:all_reduce", wait=False) or b""
         ).decode() for i in range(N)]
    res["watched_sum"] = t.numpy()
    np.savez(os.path.join(out, f"rank{r}.npz"), **res)
    with open(os.path.join(out, f"rank{r}.json"), "w") as f:
        json.dump(meta, f)
    C.barrier()
    C.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
