"""The hybrid-parallel rank topology.

Counterpart of ``paddle_tpu/distributed/topology.py``: the axis order
``AXIS_ORDER`` (data, pipe, sharding, sep, model: the model axis
innermost, so a model-parallel group's ranks are neighbours), the
cartesian ``CommunicateTopology`` (pure numpy, as the reference's) and
``HybridCommunicateGroup``, which builds one process group for each comm
list of each axis, in ``AXIS_ORDER`` (``ProcessMesh.groups`` over the
rank grid, on every rank together), and keeps the reference's
accessors. Where
the reference's group accessors return mesh axis names (its collectives
ride a mesh axis), the port's return ``collective.Group``s; its rank
accessors return this process's coordinate, where the single-controller
reference returns 0.

Built in a process that has not joined a job (``init_parallel_env``), it
takes ``rank`` and ``world_size`` as given and makes groups without a
process group: the accessors answer, a collective on them raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import env
from .collective import Group
from .process_mesh import ProcessMesh

AXIS_ORDER = ["data", "pipe", "sharding", "sep", "model"]
_SHORT = {"data": "dp", "pipe": "pp", "sharding": "sharding", "sep": "sep",
          "model": "mp"}


class CommunicateTopology:
    def __init__(self, hybrid_group_names: Sequence[str] = AXIS_ORDER,
                 dims: Sequence[int] = None):
        self._names = list(hybrid_group_names)
        self._dims = list(dims)
        if len(self._names) != len(self._dims):
            raise ValueError(f"{len(self._names)} axis names for "
                             f"{len(self._dims)} dims")

    def get_hybrid_group_names(self) -> List[str]:
        return self._names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._names.index(axis_name)]

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coords = [kwargs[n] for n in self._names]
        return int(np.ravel_multi_index(coords, self._dims))

    def get_coord(self, rank: int):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._names.index(axis_name)
        grid = np.arange(self.world_size()).reshape(self._dims)
        return [int(r) for r in np.take(grid, index, axis=axis).reshape(-1)]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Every group along ``axis_name``."""
        axis = self._names.index(axis_name)
        grid = np.arange(self.world_size()).reshape(self._dims)
        moved = np.moveaxis(grid, axis, -1).reshape(-1, self._dims[axis])
        return [[int(x) for x in row] for row in moved]


class HybridCommunicateGroup:
    """This rank's groups of a dp/pp/sharding/sep/mp decomposition."""

    def __init__(self, topology: CommunicateTopology,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        self._topo = topology
        dims = [topology.get_dim(n) for n in AXIS_ORDER]
        self._degrees = dict(zip(AXIS_ORDER, dims))
        total = int(np.prod(dims))
        world = world_size if world_size is not None else \
            env.get_world_size()
        if total != world:
            raise ValueError(f"hybrid degrees {self._degrees} need {total} "
                             f"ranks, but the job has {world}")
        self._rank = rank if rank is not None else env.get_rank()
        self._coord = dict(zip(AXIS_ORDER, topology.get_coord(self._rank)))
        self._mesh = ProcessMesh(np.arange(total).reshape(dims),
                                 [_SHORT[n] for n in AXIS_ORDER])
        self._groups: Dict[str, Group] = {
            name: self._mesh.groups(_SHORT[name])[self._rank]
            for name in AXIS_ORDER}
        # every rank builds the same groups in the same order (new_group
        # is collective), so the fused group exists only where sep > 1
        self._groups["dp_sep"] = self._groups["data"] \
            if self._degrees["sep"] == 1 else \
            self._mesh.fused_groups(("dp", "sep"), "dp_sep")[self._rank]

    @property
    def mesh(self) -> ProcessMesh:
        return self._mesh

    def axis_degree(self, short_name: str) -> int:
        for long, short in _SHORT.items():
            if short == short_name:
                return self._degrees[long]
        raise KeyError(short_name)

    def topology(self) -> CommunicateTopology:
        return self._topo

    # -- degrees --------------------------------------------------------------
    def get_num_of_pipe_stages(self) -> int:
        return self._degrees["pipe"]

    def get_model_parallel_world_size(self) -> int:
        return self._degrees["model"]

    def get_data_parallel_world_size(self) -> int:
        return self._degrees["data"]

    def get_sharding_parallel_world_size(self) -> int:
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self) -> int:
        return self._degrees["sep"]

    def get_pipe_parallel_world_size(self) -> int:
        return self._degrees["pipe"]

    # -- groups ---------------------------------------------------------------
    def get_model_parallel_group(self) -> Group:
        return self._groups["model"]

    def get_data_parallel_group(self) -> Group:
        return self._groups["data"]

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pipe"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_dp_sep_parallel_group(self) -> Group:
        """The ranks of this rank's dp and sep slices together (the dp
        group where sep is 1)."""
        return self._groups["dp_sep"]

    def get_p2p_prev_rank(self) -> int:
        """The global rank of the previous pipeline stage (a ring)."""
        g = self._groups["pipe"]
        return g.ranks[(g.ranks.index(self._rank) - 1) % g.nranks]

    def get_p2p_next_rank(self) -> int:
        """The global rank of the next pipeline stage (a ring)."""
        g = self._groups["pipe"]
        return g.ranks[(g.ranks.index(self._rank) + 1) % g.nranks]

    # -- this rank ------------------------------------------------------------
    def get_global_rank(self) -> int:
        return self._rank

    def get_model_parallel_rank(self) -> int:
        return self._coord["model"]

    def get_data_parallel_rank(self) -> int:
        return self._coord["data"]

    def get_sep_parallel_rank(self) -> int:
        return self._coord["sep"]

    def get_stage_id(self) -> int:
        """This rank's pipeline stage."""
        return self._coord["pipe"]



_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]
                                 ) -> None:
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
