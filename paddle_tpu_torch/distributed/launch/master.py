"""The job's store, hosted by the launcher.

Counterpart of ``paddle_tpu/distributed/launch/master.py``, over the
port's ``native.TCPStore`` (``torch.distributed.TCPStore``). The launcher
hosts the store and its ranks join it as clients (``PADDLE_STORE_HOSTED``):
their process group's rendezvous and the watchdog's failure notices go
through it, and it outlives any one rank. The reference's multi-node
exchanges (``sync_peers``, the restart generation) come with the
multi-node launcher (ROADMAP.md A8(e)).
"""

from __future__ import annotations

from ...native.tcp_store import TCPStore


class Master:
    def __init__(self, endpoint: str, node_rank: int = 0, nnodes: int = 1,
                 job_id: str = "default", timeout: float = 300.0):
        host, port = endpoint.rsplit(":", 1)
        self.nnodes = nnodes
        self.node_rank = node_rank
        self.prefix = f"paddle_tpu/{job_id}"
        self.store = TCPStore(host, int(port), is_master=(node_rank == 0),
                              world_size=nnodes, timeout=timeout)
        self.endpoint = f"{host}:{self.store.port}"

    def close(self) -> None:
        self.store.close()
