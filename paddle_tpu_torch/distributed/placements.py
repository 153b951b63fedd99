"""DistTensor placements: ``Shard``, ``Replicate`` and ``Partial``.

Counterpart of ``paddle_tpu/distributed/placements.py`` (:22-77), as plain
data classes: the reference translates them into JAX ``PartitionSpec``s
for GSPMD, which the port has no use for until ``shard_tensor`` and
``reshard`` come (ROADMAP.md A8(g)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


class Placement:
    def is_shard(self, dim: Optional[int] = None) -> bool:
        return False

    def is_replicate(self) -> bool:
        return False

    def is_partial(self) -> bool:
        return False


@dataclass(frozen=True)
class Replicate(Placement):
    def is_replicate(self) -> bool:
        return True


@dataclass(frozen=True)
class Shard(Placement):
    dim: int

    def is_shard(self, dim: Optional[int] = None) -> bool:
        return dim is None or dim == self.dim


@dataclass(frozen=True)
class Partial(Placement):
    reduce_type: str = "sum"

    def is_partial(self) -> bool:
        return True
