"""TCPStore: the key-value rendezvous, over ``torch.distributed.TCPStore``.

Counterpart of ``paddle_tpu/native/tcp_store.py`` (:160-273), with its
API: rank 0 passes ``is_master=True`` and hosts the server, every rank
gets a client; ``set`` / ``get`` / ``add`` (atomic) / ``wait`` /
``delete`` / ``num_keys`` / ``barrier`` (reusable: each call on a name is
a new round) / ``close``. Values are bytes; ``set`` takes bytes or
anything ``str()`` can write. ``port=0`` on the master picks a free port
(``store.port``). A timeout of 0 ms means the store's own timeout.

The reference's C++ server is not copied: c10d's store is the native
counterpart, and the process group of ``distributed.collective`` can
rendezvous over the same server (``torch_store``).
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as tdist


def _ms(ms: int) -> datetime.timedelta:
    return datetime.timedelta(milliseconds=ms)


class TCPStore:
    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 300.0):
        self.host = host
        self.is_master = is_master
        self.world_size = world_size
        self.timeout_ms = int(timeout * 1000)
        self._barrier_rounds = {}
        self._store = tdist.TCPStore(
            host, int(port), world_size, is_master,
            timeout=_ms(self.timeout_ms), wait_for_workers=False)
        self.port = self._store.port

    @property
    def torch_store(self) -> tdist.Store:
        """The c10d store, for ``init_process_group(store=...)``."""
        return self._store

    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        self._store.set(key, data)

    def get(self, key: str, wait: bool = True,
            timeout_ms: int = 0) -> Optional[bytes]:
        """The value of ``key``; with ``wait`` blocks until it is set
        (TimeoutError past the timeout), else None when it is not."""
        if wait:
            if self.wait(key, timeout_ms) != 0:
                raise TimeoutError(f"TCPStore.get({key}) timed out")
        elif not self._store.check([key]):
            return None
        return self._store.get(key)

    def add(self, key: str, delta: int = 1) -> int:
        return int(self._store.add(key, int(delta)))

    def wait(self, key: str, timeout_ms: int = 0) -> int:
        """0 once ``key`` is set, -1 when the timeout passes first."""
        try:
            self._store.wait([key], _ms(timeout_ms or self.timeout_ms))
        except (tdist.DistStoreError, RuntimeError):
            return -1
        return 0

    def delete(self, key: str) -> bool:
        return bool(self._store.delete_key(key))

    def num_keys(self) -> int:
        return int(self._store.num_keys())

    def barrier(self, name: str, rank_count: Optional[int] = None,
                timeout_ms: int = 60_000) -> None:
        """All ``rank_count`` participants (default: the world size)
        arrive before any leaves. Each call on a name is a new round (a
        local round counter), so round k's done key never satisfies round
        k + 1."""
        n = rank_count or self.world_size
        rnd = self._barrier_rounds.get(name, 0)
        self._barrier_rounds[name] = rnd + 1
        tag = f"__barrier/{name}/{rnd}"
        arrived = self.add(f"{tag}/count", 1)
        if arrived >= n:
            self.set(f"{tag}/done", b"1")
        if self.wait(f"{tag}/done", timeout_ms) != 0:
            raise TimeoutError(f"barrier '{name}' round {rnd} timed out "
                               f"({arrived}/{n} arrived)")

    def close(self) -> None:
        """Drops this handle's store (the master's server stops when no
        handle holds it)."""
        self._store = None
