"""``paddle.distributed.fleet``: the preemption signal handler only
(:mod:`.elastic`). The elastic manager, the TCPStore rendezvous and the
parallel layers are ROADMAP.md A8."""

from .elastic import PreemptionHandler

__all__ = ["PreemptionHandler"]
