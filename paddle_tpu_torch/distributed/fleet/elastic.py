"""The preemption signal handler.

Counterpart of ``PreemptionHandler`` in
``paddle_tpu/distributed/fleet/elastic.py`` (:244-307), which the serving
engine's ``install_signal=True`` wires to its drain. The reference's
handler also broadcasts the notice through an ``ElasticManager`` over the
job's TCPStore; that manager (and the store) are not ported yet
(ROADMAP.md, A8), so a manager other than None raises.

The signal handler itself only sets a flag (a signal handler must not
take locks or do I/O); :meth:`PreemptionHandler.process` runs the
callback and belongs in the serve or training loop::

    handler = PreemptionHandler(None, on_notice=drain).install()
    ...
    if handler.process():   # once per step
        exit
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Wires an OS preemption signal (SIGTERM by default) into the loop
    that polls :meth:`process`."""

    def __init__(self, manager=None,
                 on_notice: Optional[Callable[[], None]] = None):
        if manager is not None:
            raise NotImplementedError(
                "PreemptionHandler(manager): the elastic manager and its "
                "TCPStore broadcast are not ported yet (ROADMAP.md, A8); "
                "pass None")
        self.manager = manager
        self.on_notice = on_notice
        self._prev_handler = None
        self._signum = None
        self._flag = threading.Event()
        self._processed = False
        self.notices = 0

    def install(self, signum: Optional[int] = None):
        self._signum = signum if signum is not None else signal.SIGTERM
        self._prev_handler = signal.signal(self._signum, self._handle)
        return self

    def _handle(self, signum, frame):
        # async-signal-safe: flag only, no locks, no I/O
        self.notices += 1
        self._flag.set()
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)

    def pending(self) -> bool:
        return self._flag.is_set() and not self._processed

    def process(self) -> bool:
        """Run the callback if a notice arrived. Returns True when this
        process is under notice. Call once per step."""
        if not self.pending():
            return self._processed
        self._processed = True
        if self.on_notice is not None:
            self.on_notice()
        return True

    def uninstall(self):
        if self._signum is not None and self._prev_handler is not None:
            signal.signal(self._signum, self._prev_handler)
            self._signum = None
