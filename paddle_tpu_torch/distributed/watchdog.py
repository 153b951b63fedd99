"""The collective hang watchdog.

Counterpart of ``paddle_tpu/distributed/watchdog.py`` (the reference's
``comm_task_manager.h:37``): every eager collective of
``distributed.collective`` runs inside ``comm_watchdog().start_task(name,
timeout_s, rank)``. A scan thread finds the tasks that outlive their
timeout (``FLAGS_comm_timeout_s``), fires the registered handlers with
each, and, where a store is attached (``attach_store``), publishes
``comm_error/<rank>/<task>`` so every rank learns which rank stalled on
which collective. A handler that raises is recorded in the flight
recorder and the other handlers still run.

A task ends when its call is done. A call that returns done (gloo blocks
until its peers came) ends its task as it returns. A call that returns
once its work is queued (NCCL) hands the task a ``ready`` test, the
query of a CUDA event recorded behind the work (``finish_when``): the
task stays open, and the scan ends it once ``ready()`` holds, so a peer
that never comes trips the timeout there too.

The watchdog detects; it does not cancel. A collective whose peer never
comes stays blocked until the process group's own timeout, which is the
caller's to set (``init_parallel_env(timeout_s=...)``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class CommTask:
    _next_id = 0
    _id_lock = threading.Lock()

    def __init__(self, name: str, timeout_s: float, rank: int):
        with CommTask._id_lock:
            CommTask._next_id += 1
            self.task_id = CommTask._next_id
        self.name = name
        self.timeout_s = timeout_s
        self.rank = rank
        self.start = time.monotonic()
        self.done = False
        self._mgr: Optional["CommTaskManager"] = None
        self._ready: Optional[Callable[[], bool]] = None

    def is_timeout(self) -> bool:
        return not self.done and self.elapsed() > self.timeout_s

    def elapsed(self) -> float:
        return time.monotonic() - self.start

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._mgr.finish_task(self)
        return False


def _record(event: str, err: Exception, task: CommTask) -> None:
    """A store or handler failure into the flight recorder; a recorder
    failure never stops the scan."""
    try:
        from ..observability import flight_recorder as fr
        if fr.enabled():
            fr.recorder().record(event, (f"{type(err).__name__}: {err}",
                                         task.name), None)
    except Exception:
        pass


class CommTaskManager:
    def __init__(self, scan_interval: float = 0.5):
        self._tasks: Dict[int, CommTask] = {}
        self._lock = threading.Lock()
        self._handlers: List[Callable[[CommTask], None]] = []
        self._timed_out: List[CommTask] = []
        self._scan_interval = scan_interval
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._store = None

    def attach_store(self, store, rank: int = 0) -> None:
        """Publish timeouts into ``store`` (``native.TCPStore``)."""
        self._store = (store, rank)

    def add_handler(self, fn: Callable[[CommTask], None]) -> None:
        self._handlers.append(fn)

    def start_task(self, name: str, timeout_s: float = 600.0,
                   rank: int = 0) -> CommTask:
        t = CommTask(name, timeout_s, rank)
        t._mgr = self
        with self._lock:
            self._tasks[t.task_id] = t
            if self._thread is None or not self._thread.is_alive():
                self._stop = threading.Event()
                self._thread = threading.Thread(
                    target=self._scan_loop, name="comm-watchdog",
                    daemon=True)
                self._thread.start()
        return t

    def finish_task(self, t: CommTask) -> None:
        t.done = True
        with self._lock:
            self._tasks.pop(t.task_id, None)

    def finish_when(self, t: CommTask, ready: Callable[[], bool]) -> None:
        """End ``t`` at the first scan where ``ready()`` holds (an error
        from ``ready`` ends it too, recorded)."""
        t._ready = ready

    def _settled(self, t: CommTask) -> bool:
        if t._ready is None:
            return False
        try:
            return bool(t._ready())
        except Exception as e:
            _record("watchdog.ready_error", e, t)
            return True

    def timed_out_tasks(self) -> List[CommTask]:
        with self._lock:
            return list(self._timed_out)

    def _scan_loop(self) -> None:
        stop = self._stop
        while not stop.wait(self._scan_interval):
            with self._lock:
                for t in [t for t in self._tasks.values()
                          if self._settled(t)]:
                    t.done = True
                    self._tasks.pop(t.task_id, None)
                overdue = [t for t in self._tasks.values() if t.is_timeout()]
                for t in overdue:
                    self._tasks.pop(t.task_id, None)
                    self._timed_out.append(t)
            for t in overdue:
                if self._store is not None:
                    store, rank = self._store
                    try:
                        store.set(f"comm_error/{rank}/{t.name}",
                                  f"timeout after {t.elapsed():.1f}s")
                    except Exception as e:
                        _record("watchdog.store_error", e, t)
                for fn in self._handlers:
                    try:
                        fn(t)
                    except Exception as e:
                        _record("watchdog.handler_error", e, t)

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


_manager: Optional[CommTaskManager] = None


def comm_watchdog() -> CommTaskManager:
    global _manager
    if _manager is None:
        _manager = CommTaskManager()
    return _manager
