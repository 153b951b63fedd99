"""The collective controller: start this node's ranks and watch them.

Counterpart of ``paddle_tpu/distributed/launch/controller.py``
(single-node collective mode). Each rank gets the reference's variables
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
``PADDLE_NNODES``, ``PADDLE_NODE_RANK``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_MASTER``, ``PADDLE_JOB_ID``,
``PADDLE_RESTART_COUNT``, ``PADDLE_DEVICES`` from ``--devices``), torch's
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and ``MASTER_ADDR`` /
``MASTER_PORT`` of the job's store, which the launcher hosts
(:class:`.master.Master`, ``PADDLE_STORE_HOSTED=1``). A job of more than
one rank logs each rank to ``<log_dir>/<job_id>.<node>.<rank>.log``.

A rank that exits non-zero stops the others; its log's tail goes to
stderr, and the pod restarts, with a fresh store, up to ``--max_restart``
times, after which the launch fails (exit 1). A SIGTERM or Ctrl-C to the
launcher stops the ranks before it exits (143 / 130). A SIGKILL cannot
be caught: a caller that may need one starts the launcher in a session
of its own (``start_new_session=True``) and kills the whole group
(``os.killpg``), which holds the ranks too.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
from typing import List, Optional

from .context import Context
from .job import Container, Pod
from .master import Master


class CollectiveController:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.pod = Pod(f"pod_{ctx.args.node_rank}")
        self.master: Optional[Master] = None
        self.restarts = 0

    def build_pod(self) -> Pod:
        a = self.ctx.args
        nproc = a.nproc_per_node
        ip = self.ctx.node_ip
        if self.master is not None:
            self.master.close()
        self.master = Master(a.master or f"{ip}:0", 0, 1, a.job_id)
        addr, port = self.master.endpoint.rsplit(":", 1)
        endpoints = [f"{ip}:trainer0_{i}" for i in range(nproc)]
        self.pod.clear()
        for rank in range(nproc):
            env = {
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(nproc),
                "PADDLE_LOCAL_RANK": str(rank),
                "PADDLE_NNODES": "1",
                "PADDLE_NODE_RANK": str(a.node_rank),
                "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
                "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
                "PADDLE_MASTER": self.master.endpoint,
                "PADDLE_JOB_ID": a.job_id,
                "PADDLE_RESTART_COUNT": str(self.restarts),
                "PADDLE_STORE_HOSTED": "1",
                "RANK": str(rank),
                "WORLD_SIZE": str(nproc),
                "LOCAL_RANK": str(rank),
                "MASTER_ADDR": addr,
                "MASTER_PORT": port,
            }
            if a.devices:
                env["PADDLE_DEVICES"] = a.devices
            log = None if nproc == 1 else os.path.join(
                a.log_dir, f"{a.job_id}.{a.node_rank}.{rank}.log")
            self.pod.add(Container(
                [sys.executable, "-u", a.training_script,
                 *a.training_script_args], env, log_path=log))
        return self.pod

    def _report(self, failed: List[Container]) -> None:
        for c in failed:
            print(f"launch: rank {c.rank} exited with code {c.exit_code()}"
                  + (f"; the tail of {c.log_path}:\n{c.log_tail()}"
                     if c.log_path else ""), file=sys.stderr, flush=True)

    def run(self) -> int:
        a = self.ctx.args
        try:
            while True:
                self.build_pod()
                self.pod.deploy()
                status = self.pod.join()
                if status == "done":
                    return 0
                failed = self.pod.failed()
                self.pod.stop()
                self._report(failed)
                if self.restarts >= a.max_restart:
                    self.ctx.status = "failed"
                    return 1
                self.restarts += 1
                self.ctx.status = "restarting"
                print(f"launch: restart {self.restarts} of {a.max_restart}",
                      file=sys.stderr, flush=True)
        finally:
            self.stop()

    def stop(self) -> None:
        self.pod.stop()
        if self.master is not None:
            self.master.close()
            self.master = None


class _Terminated(Exception):
    pass


def _raise_terminated(signum, frame):
    raise _Terminated(signum)


def launch(argv: Optional[List[str]] = None) -> int:
    ctx = Context(argv)
    ctl = CollectiveController(ctx)
    main = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, _raise_terminated) if main else None
    try:
        return ctl.run()       # its ``finally`` stops the ranks
    except KeyboardInterrupt:
        return 130
    except _Terminated:
        return 143
    finally:
        ctl.stop()
        if main:
            signal.signal(signal.SIGTERM, prev)
