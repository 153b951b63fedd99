"""``paddle.distributed.fleet``: hybrid-parallel training.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``:

- ``DistributedStrategy`` (``hybrid_configs``: ``dp_degree``,
  ``mp_degree``, ``pp_degree``, ``sharding_degree``, ``sep_degree``;
  ``pipeline_configs``: ``accumulate_steps`` (the microbatches),
  ``schedule_mode`` (FThenB / 1F1B / Eager1F1B, default 1F1B),
  ``virtual_pp_degree``);
- ``init(is_collective=True, strategy=, backend=)``: joins the job
  (``init_parallel_env(backend)``: NCCL unless ``backend="gloo"``), then
  builds the ``HybridCommunicateGroup``; the dp degree soaks up the world
  size where the other degrees' product divides it (:84-85, with ranks
  for devices). Calling it again builds new groups;
- ``distributed_model(model)`` (:150-167): a ``PipelineLayer`` (or a
  model built under pp > 1, which keeps only its stage) in
  ``PipelineParallel``; under sep > 1 ``SegmentParallel``, which hands
  each sep rank its chunk of the sequence and averages the replicated
  grads over dp x sep; else ``DataParallel`` over the dp group when dp >
  1 (tensor-parallel layers were cut at construction);
- ``distributed_optimizer(optimizer)``: a ``ClipGradByGlobalNorm`` becomes
  ``HybridParallelClipGrad`` where the parameters are cut over ranks (mp,
  pp, or expert parallelism): every parameter's squares count once, so
  every rank clips by the exact global norm that GSPMD gives the reference
  (``paddle_tpu/nn/clip.py:52-60``).

The parallel layers (:mod:`.mp_layers`, :mod:`.sequence_parallel_utils`),
the pipeline's layers and wrappers (:mod:`.pp_layers`,
:mod:`.meta_parallel`) and the preemption signal handler (:mod:`.elastic`)
live here too. ZeRO (``sharding_degree`` > 1) raises, naming its ROADMAP.md
item (A8(d)); so do ``ShardingParallel`` and the elastic manager (A8(e)),
and the pipeline under sequence parallelism (``pp_degree`` and
``sep_degree`` both > 1, A8(h)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...nn.clip import ClipGradByGlobalNorm, sum_of_squares
from .. import collective as C
from ..topology import (AXIS_ORDER, CommunicateTopology,
                        HybridCommunicateGroup, get_hybrid_communicate_group,
                        set_hybrid_communicate_group)
from . import mp_layers  # noqa: F401
from .elastic import PreemptionHandler
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)

__all__ = ["DistributedStrategy", "init", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "get_strategy", "HybridParallelClipGrad", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "PreemptionHandler",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer", "MetaParallelBase",
           "TensorParallel", "SegmentParallel", "PipelineParallel",
           "ShardingParallel"]

_LATER = {
    "sharding_degree": "ZeRO sharding is ROADMAP.md A8(d)",
}
_strategy: Optional["DistributedStrategy"] = None


class DistributedStrategy:
    """The reference's ``DistributedStrategy`` as a plain config object."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1, "schedule_mode": "",
                                 "virtual_pp_degree": 1}
        self.sharding_configs = {"stage": 1}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


def init(role_maker=None, is_collective: bool = False,
         strategy: Optional[DistributedStrategy] = None,
         backend: Optional[str] = None) -> HybridCommunicateGroup:
    global _strategy
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    for key, why in _LATER.items():
        if int(hc.get(key, 1)) > 1:
            raise NotImplementedError(f"fleet.init({key}="
                                      f"{hc[key]}): {why}")
    if int(hc.get("pp_degree", 1)) > 1 and int(hc.get("sep_degree", 1)) > 1:
        raise NotImplementedError(
            "fleet.init(pp_degree > 1, sep_degree > 1): the pipeline does "
            "not cut its microbatches over sep; ROADMAP.md A8(h)")
    C.init_parallel_env(backend)
    _strategy = strategy
    degrees = {"data": int(hc.get("dp_degree", 1)),
               "pipe": int(hc.get("pp_degree", 1)), "sharding": 1,
               "sep": int(hc.get("sep_degree", 1)),
               "model": int(hc.get("mp_degree", 1))}
    prod = int(np.prod(list(degrees.values())))
    world = C.get_world_size()
    if prod < world and world % prod == 0:
        degrees["data"] *= world // prod
    topo = CommunicateTopology(AXIS_ORDER, [degrees[n] for n in AXIS_ORDER])
    hcg = HybridCommunicateGroup(topo)
    set_hybrid_communicate_group(hcg)
    return hcg


def get_strategy() -> Optional[DistributedStrategy]:
    """The strategy of the last ``init``."""
    return _strategy


def _hcg() -> HybridCommunicateGroup:
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init(is_collective=True) first")
    return hcg


def distributed_model(model):
    """``PipelineParallel`` under pp > 1, ``SegmentParallel`` under sep >
    1, ``DataParallel(model)`` over the dp group when dp > 1, else the
    model as it is."""
    hcg = _hcg()
    from .meta_parallel import PipelineParallel, SegmentParallel
    from .pp_layers import PipelineLayer
    if hcg.get_pipe_parallel_world_size() > 1 or \
            isinstance(model, PipelineLayer):
        return PipelineParallel(model, hcg, _strategy)
    if hcg.get_sep_parallel_world_size() > 1:
        return SegmentParallel(model, hcg, _strategy)
    if hcg.get_data_parallel_world_size() > 1:
        from ..parallel import DataParallel
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip of a model cut over ranks, each parameter's
    squares counted once: those of the ``is_distributed`` parameters
    (model-parallel shards) all-reduced over ``group``, those of the
    experts of an expert-parallel layer over their ``expert_group``, the
    replicated ones once; under the pipeline the stage's sum all-reduced
    over ``pp_group``, a weight shared by stages (``SharedLayerDesc``)
    counted on its first stage only."""

    def __init__(self, clip_norm, group: Optional[C.Group],
                 pp_group: Optional[C.Group] = None):
        super().__init__(clip_norm)
        self.group = group
        self.pp_group = pp_group

    def sum_of_squares(self, grads, params) -> torch.Tensor:
        grads = list(grads)
        if params is None:
            raise ValueError("HybridParallelClipGrad needs the parameters "
                             "of the grads")
        ref = grads[0]

        def zero():
            return torch.zeros((), dtype=torch.float32, device=ref.device)

        cut, whole, experts = [], [], {}
        for g, p in zip(grads, params):
            if getattr(p, "pipeline_shared_copy", False):
                continue                # counted on its first stage
            eg = getattr(p, "expert_group", None)
            if eg is not None:
                experts.setdefault(id(eg), (eg, []))[1].append(g)
            elif getattr(p, "is_distributed", False) is True:
                # the mp layers' flag: torch's own ``is_distributed`` is a
                # method, truthy on every parameter
                cut.append(g)
            else:
                whole.append(g)
        total = sum_of_squares(whole) if whole else zero()
        if self.group is not None and self.group.nranks > 1:
            part = (sum_of_squares(cut) if cut else zero()).reshape(1)
            C.all_reduce(part, group=self.group)
            total = total + part.reshape(())
        elif cut:
            total = total + sum_of_squares(cut)
        for eg, gs in experts.values():
            part = sum_of_squares(gs).reshape(1)
            C.all_reduce(part, group=eg)
            total = total + part.reshape(())
        if self.pp_group is not None and self.pp_group.nranks > 1:
            total = total.reshape(1).clone()
            C.all_reduce(total, group=self.pp_group)
            total = total.reshape(())
        return total


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """The optimizer, its global-norm clip spanning the ranks the
    parameters are cut over."""
    hcg = _hcg()
    clip = getattr(optimizer, "_grad_clip", None)
    params = getattr(optimizer, "_parameter_list", None) or []
    experts = any(getattr(p, "expert_group", None) is not None
                  for p in params)
    mp = hcg.get_model_parallel_world_size() > 1
    pp = hcg.get_pipe_parallel_world_size() > 1
    if type(clip) is ClipGradByGlobalNorm and (mp or pp or experts):
        optimizer._grad_clip = HybridParallelClipGrad(
            clip.clip_norm, hcg.get_model_parallel_group(),
            hcg.get_pipe_parallel_group() if pp else None)
    return optimizer


from . import sequence_parallel_utils  # noqa: E402,F401
from .sequence_parallel_utils import (  # noqa: E402,F401
    AllGatherOp, ColumnSequenceParallelLinear, GatherOp, ReduceScatterOp,
    RowSequenceParallelLinear, ScatterOp, mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)
from .pp_layers import (  # noqa: E402,F401
    LayerDesc, PipelineLayer, SharedLayerDesc)
from .meta_parallel import (  # noqa: E402,F401
    MetaParallelBase, PipelineParallel, SegmentParallel, ShardingParallel,
    TensorParallel)
