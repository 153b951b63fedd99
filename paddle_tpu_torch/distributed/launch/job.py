"""A Pod (this node's ranks) of Containers (one process each).

Counterpart of ``paddle_tpu/distributed/launch/job.py``: each Container is
a subprocess with its environment and, for a job of more than one rank,
its log file; a Pod starts, polls and stops them together.
:func:`kill_group` ends a launcher started in a session of its own, with
its ranks.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional


def kill_group(proc: subprocess.Popen) -> None:
    """SIGKILL what is left of the session that ``proc`` leads (started
    with ``start_new_session=True``): ``proc`` and every process it
    started, the launcher's ranks included. Then reap ``proc``."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


class Container:
    def __init__(self, entrypoint: List[str], env: Dict[str, str],
                 log_path: Optional[str] = None):
        self.entrypoint = entrypoint
        self.env = env
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._log_f = None

    def start(self) -> None:
        full_env = dict(os.environ)
        full_env.update(self.env)
        out = sys.stdout
        if self.log_path:
            os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
            self._log_f = open(self.log_path, "w")
            out = self._log_f
        self.proc = subprocess.Popen(self.entrypoint, env=full_env,
                                     stdout=out, stderr=subprocess.STDOUT)

    def exit_code(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    @property
    def rank(self) -> int:
        return int(self.env.get("PADDLE_TRAINER_ID", -1))

    def terminate(self, force: bool = False) -> None:
        if self.proc is None or self.proc.poll() is not None:
            return
        self.proc.kill() if force else self.proc.terminate()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None

    def log_tail(self, n: int = 40) -> str:
        if not self.log_path or not os.path.exists(self.log_path):
            return ""
        with open(self.log_path, errors="replace") as f:
            return "".join(f.readlines()[-n:])

    def close_log(self) -> None:
        if self._log_f:
            self._log_f.close()
            self._log_f = None


class Pod:
    def __init__(self, name: str = "pod"):
        self.name = name
        self.containers: List[Container] = []

    def add(self, c: Container) -> None:
        self.containers.append(c)

    def deploy(self) -> None:
        for c in self.containers:
            c.start()

    def poll(self) -> str:
        """'running' | 'done' | 'failed'"""
        codes = [c.exit_code() for c in self.containers]
        if any(c is not None and c != 0 for c in codes):
            return "failed"
        if all(c == 0 for c in codes):
            return "done"
        return "running"

    def failed(self) -> List[Container]:
        return [c for c in self.containers
                if c.exit_code() not in (None, 0)]

    def join(self, timeout: Optional[float] = None) -> str:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            st = self.poll()
            if st != "running":
                return st
            if deadline is not None and time.monotonic() > deadline:
                return "running"
            time.sleep(0.1)

    def stop(self, grace: float = 5.0) -> None:
        for c in self.containers:
            c.terminate()
        deadline = time.monotonic() + grace
        for c in self.containers:
            if c.proc is not None and c.exit_code() is None:
                c.wait(max(0.0, deadline - time.monotonic()))
        for c in self.containers:
            if c.exit_code() is None:
                c.terminate(force=True)
                c.wait(grace)
            c.close_log()

    def clear(self) -> None:
        self.containers = []
