"""ProcessMesh: a grid of ranks with named dims.

Counterpart of ``paddle_tpu/distributed/process_mesh.py``, where a mesh
wraps a JAX device ``Mesh``. Here it is the rank grid itself, and
:meth:`ProcessMesh.groups` builds one process group for each slice along
a dim, the analogue of a mesh axis that a collective rides.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class ProcessMesh:
    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None):
        arr = np.asarray(mesh, dtype=np.int64)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(f"{len(dim_names)} dim names for a "
                             f"{arr.ndim}-d mesh")
        self._ids = arr
        self._names = list(dim_names)
        self._groups: Dict[str, Dict[int, object]] = {}

    @property
    def shape(self) -> List[int]:
        return [int(s) for s in self._ids.shape]

    @property
    def ndim(self) -> int:
        return self._ids.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._names)

    @property
    def process_ids(self) -> List[int]:
        return [int(i) for i in self._ids.reshape(-1)]

    @property
    def size(self) -> int:
        return int(self._ids.size)

    def get_dim_size(self, dim_name: str) -> int:
        return self.shape[self._names.index(dim_name)]

    def get_mesh_with_dim(self, dim_name: str, index: Optional[int] = None):
        """The mesh with ``dim_name`` moved first, or its slice at
        ``index`` along that dim."""
        axis = self._names.index(dim_name)
        if index is None:
            order = [axis] + [i for i in range(self.ndim) if i != axis]
            return ProcessMesh(np.transpose(self._ids, order),
                               [self._names[i] for i in order])
        arr = np.take(self._ids, index, axis=axis)
        names = [n for i, n in enumerate(self._names) if i != axis]
        if arr.ndim == 0:
            arr, names = arr.reshape(1), [dim_name]
        return ProcessMesh(arr, names)

    def groups(self, dim_name: str) -> Dict[int, object]:
        """``{rank: Group}``: one group for each slice of ranks along
        ``dim_name`` (one per position of the other dims, in row-major
        order), built once. Every rank of the job builds them together
        (torch's ``new_group`` is collective); in a process that has not
        joined one, the groups have no process group."""
        if dim_name not in self._groups:
            from .collective import Group, is_initialized, new_group
            axis = self._names.index(dim_name)
            moved = np.moveaxis(self._ids, axis, -1)
            made = {}
            for row in moved.reshape(-1, self.shape[axis]):
                ranks = [int(r) for r in row]
                g = new_group(ranks, axis=dim_name) if is_initialized() \
                    else Group(dim_name, len(ranks), ranks)
                made.update(dict.fromkeys(ranks, g))
            self._groups[dim_name] = made
        return self._groups[dim_name]

    def fused_groups(self, dim_names: Sequence[str], axis: str
                     ) -> Dict[int, object]:
        """``{rank: Group}`` over several dims taken together: one group
        for each position of the other dims, named ``axis``, built once
        (collectively, as :meth:`groups`)."""
        key = "+".join(dim_names)
        if key not in self._groups:
            from .collective import Group, is_initialized, new_group
            axes = [self._names.index(n) for n in dim_names]
            moved = np.moveaxis(self._ids, axes, list(range(-len(axes), 0)))
            n = int(np.prod([self.shape[a] for a in axes]))
            made = {}
            for row in moved.reshape(-1, n):
                ranks = [int(r) for r in row]
                g = new_group(ranks, axis=axis) if is_initialized() \
                    else Group(axis, len(ranks), ranks)
                made.update(dict.fromkeys(ranks, g))
            self._groups[key] = made
        return self._groups[key]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and self.shape == other.shape
                and self._names == other._names
                and np.array_equal(self._ids, other._ids))

    def __hash__(self):
        return hash((tuple(self.shape), tuple(self._names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self._names})"


_global_mesh: Optional[ProcessMesh] = None


def create_mesh(shape: Sequence[int], dim_names: Sequence[str]
                ) -> ProcessMesh:
    """Ranks ``0 .. prod(shape) - 1`` laid out row-major: the last dim's
    ranks are neighbours, as the reference's topology puts the model
    axis innermost."""
    return ProcessMesh(np.arange(int(np.prod(shape))).reshape(tuple(shape)),
                       dim_names)


def set_mesh(mesh: ProcessMesh) -> None:
    global _global_mesh
    _global_mesh = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _global_mesh
