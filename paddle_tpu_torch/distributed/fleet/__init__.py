"""``paddle.distributed.fleet``: hybrid-parallel training.

Counterpart of ``paddle_tpu/distributed/fleet/__init__.py``:

- ``DistributedStrategy`` (``hybrid_configs``: ``dp_degree``,
  ``mp_degree``, ``pp_degree``, ``sharding_degree``, ``sep_degree``);
- ``init(is_collective=True, strategy=, backend=)``: joins the job
  (``init_parallel_env(backend)``: NCCL unless ``backend="gloo"``), then
  builds the ``HybridCommunicateGroup``; the dp degree soaks up the world
  size where the other degrees' product divides it (:84-85, with ranks
  for devices). Calling it again builds new groups;
- ``distributed_model(model)``: ``DataParallel`` over the dp group when
  dp > 1 (tensor-parallel layers were cut at construction);
- ``distributed_optimizer(optimizer)``: a ``ClipGradByGlobalNorm`` becomes
  ``HybridParallelClipGrad``: the squared norms of model-parallel shards
  (``is_distributed`` parameters) are summed over the mp group, a
  replicated parameter (the RMSNorm weights, a row-parallel bias) counts
  once, so every rank clips by the exact global norm that GSPMD gives the
  reference (``paddle_tpu/nn/clip.py:52-60``).

The parallel layers (:mod:`.mp_layers`) and the preemption signal handler
(:mod:`.elastic`) live here too. Sequence parallelism, the pipeline and
ZeRO (``sep_degree``, ``pp_degree``, ``sharding_degree`` > 1) raise,
naming their ROADMAP.md items (A8(a), (c), (d)); so does the elastic
manager (A8(e)).
"""

from __future__ import annotations

from typing import Optional

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
           "HybridParallelClipGrad", "ColumnParallelLinear",
           "RowParallelLinear", "VocabParallelEmbedding",
           "ParallelCrossEntropy", "PreemptionHandler"]

_LATER = {
    "sep_degree": "sequence parallelism is ROADMAP.md A8(a)",
    "pp_degree": "the pipeline is ROADMAP.md A8(c)",
    "sharding_degree": "ZeRO sharding is ROADMAP.md A8(d)",
}


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
                                 "micro_batch_size": 1, "schedule_mode": ""}
        self.sharding_configs = {"stage": 1}

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


def init(role_maker=None, is_collective: bool = False,
         strategy: Optional[DistributedStrategy] = None,
         backend: Optional[str] = None) -> HybridCommunicateGroup:
    strategy = strategy or DistributedStrategy()
    C.init_parallel_env(backend)
    hc = strategy.hybrid_configs
    for key, why in _LATER.items():
        if int(hc.get(key, 1)) > 1:
            raise NotImplementedError(f"fleet.init({key}="
                                      f"{hc[key]}): {why}")
    degrees = {"data": int(hc.get("dp_degree", 1)), "pipe": 1,
               "sharding": 1, "sep": 1,
               "model": int(hc.get("mp_degree", 1))}
    prod = degrees["data"] * degrees["model"]
    world = C.get_world_size()
    if prod < world and world % prod == 0:
        degrees["data"] *= world // prod
    topo = CommunicateTopology(AXIS_ORDER, [degrees[n] for n in AXIS_ORDER])
    hcg = HybridCommunicateGroup(topo)
    set_hybrid_communicate_group(hcg)
    return hcg


def _hcg() -> HybridCommunicateGroup:
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("call fleet.init(is_collective=True) first")
    return hcg


def distributed_model(model):
    """``DataParallel(model)`` over the dp group when dp > 1, else the
    model as it is."""
    hcg = _hcg()
    if hcg.get_data_parallel_world_size() > 1:
        from ..parallel import DataParallel
        return DataParallel(model, group=hcg.get_data_parallel_group())
    return model


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip of a model-parallel model: ``sum |g|^2`` of
    the ``is_distributed`` parameters' grads all-reduced over ``group``,
    plus that of the replicated ones, once."""

    def __init__(self, clip_norm, group: C.Group):
        super().__init__(clip_norm)
        self.group = group

    def sum_of_squares(self, grads, params) -> torch.Tensor:
        grads = list(grads)
        if params is None:
            raise ValueError("HybridParallelClipGrad needs the parameters "
                             "of the grads")
        cut = [g for g, p in zip(grads, params)
               if getattr(p, "is_distributed", False)]
        whole = [g for g, p in zip(grads, params)
                 if not getattr(p, "is_distributed", False)]
        ref = grads[0]
        part = sum_of_squares(cut) if cut else \
            torch.zeros((), dtype=torch.float32, device=ref.device)
        part = part.reshape(1).clone()
        C.all_reduce(part, group=self.group)
        total = part.reshape(())
        return total + sum_of_squares(whole) if whole else total


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """The optimizer, its global-norm clip spanning the mp group."""
    hcg = _hcg()
    clip = getattr(optimizer, "_grad_clip", None)
    if (hcg.get_model_parallel_world_size() > 1
            and type(clip) is ClipGradByGlobalNorm):
        optimizer._grad_clip = HybridParallelClipGrad(
            clip.clip_norm, hcg.get_model_parallel_group())
    return optimizer
