"""``paddle.distributed``, over ``torch.distributed``: one process per rank.

Counterpart of ``paddle_tpu/distributed/``'s first part: the collectives
(:mod:`.collective`), the rank environment (:mod:`.env`), the watchdog
(:mod:`.watchdog`), ``ProcessMesh`` and the placements, the hybrid
topology (:mod:`.topology`), ``fleet`` with the tensor-parallel layers,
``DataParallel`` (:mod:`.parallel`), ``spawn``, the launcher
(``python -m paddle_tpu_torch.distributed.launch``), activation
recomputation (:mod:`.recompute`), and since the second part sequence
parallelism (``fleet.sequence_parallel_utils``, ``SegmentParallel`` and
``ops/kernels/ring_attention.py``), expert parallelism (``moe_ffn``'s
``expert_axis``) and the pipeline (:mod:`.pp_schedules`,
:mod:`.pipeline`, ``fleet.pp_layers``, ``PipelineParallel``). ZeRO, the
resharded checkpoints, resilience, the elastic manager and the semi-auto
API (``shard_tensor`` / ``reshard``) and the pipeline under sequence
parallelism are ROADMAP.md A8's remaining items (d)-(h).
"""

from . import env  # noqa: F401
from . import fleet  # noqa: F401
from . import pipeline  # noqa: F401
from . import pp_schedules  # noqa: F401
from . import watchdog  # noqa: F401
from .collective import (P2POp, ParallelEnv, ReduceOp, Group, all_gather,
                         all_gather_object, all_reduce, all_to_all, barrier,
                         batch_isend_irecv, broadcast, destroy_process_group,
                         get_backend, get_rank, get_world_size,
                         init_parallel_env, irecv, is_initialized, isend,
                         new_group, recv, reduce, reduce_scatter, scatter,
                         scatter_object_list, send)
from .parallel import DataParallel
from .placements import Partial, Placement, Replicate, Shard
from .pp_schedules import build_fb_schedule, schedule_report
from .process_mesh import ProcessMesh, create_mesh, get_mesh, set_mesh
from .recompute import dots_saveable, recompute, recompute_sequential
from .spawn import spawn
from .topology import (AXIS_ORDER, CommunicateTopology,
                       HybridCommunicateGroup, get_hybrid_communicate_group)
from .watchdog import comm_watchdog

__all__ = [
    "AXIS_ORDER", "CommunicateTopology", "DataParallel", "Group",
    "build_fb_schedule", "pipeline", "pp_schedules", "schedule_report",
    "HybridCommunicateGroup", "P2POp", "ParallelEnv", "Partial",
    "Placement", "ProcessMesh", "ReduceOp", "Replicate", "Shard",
    "all_gather", "all_gather_object", "all_reduce", "all_to_all",
    "barrier", "batch_isend_irecv", "broadcast", "comm_watchdog",
    "create_mesh", "destroy_process_group", "dots_saveable", "env",
    "fleet", "get_backend", "get_hybrid_communicate_group", "get_mesh",
    "get_rank", "get_world_size", "init_parallel_env", "irecv",
    "is_initialized", "isend", "new_group", "recompute",
    "recompute_sequential", "recv", "reduce", "reduce_scatter", "scatter",
    "scatter_object_list", "send", "set_mesh", "spawn", "watchdog"]
