"""The native runtime layer: the TCPStore rendezvous.

Counterpart of ``paddle_tpu/native/``, whose store is a C++ server of its
own bound through ctypes. The port's store is ``torch.distributed.
TCPStore`` (c10d's C++ store), wrapped in the reference's API
(:mod:`.tcp_store`).
"""

from .tcp_store import TCPStore

__all__ = ["TCPStore"]
