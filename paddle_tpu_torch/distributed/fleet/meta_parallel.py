"""Meta-parallel model wrappers: tensor, segment (sequence) and pipeline.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel.py``. The
reference's wrappers move no bytes (GSPMD does); the port's do:

- ``TensorParallel``: the model as it is (its mp layers were cut at
  construction, their collectives in their forwards);
- ``SegmentParallel`` (reference :71-74): each sep rank gets its chunk of
  the sequence of every ``[b, s]`` or ``[b, s, ...]`` input (ids, labels
  passed through the wrapper, position ids), so user code stays as it is
  at sep 1; the model's attention runs the ring over the sep group
  (``ops/kernels/ring_attention.py``) and its criterion takes the shifted
  labels across the shards. The replicated parameters' grads are
  averaged over the dp x sep group by a ``DataParallel`` reducer;
- ``PipelineParallel`` (reference :104-140): ``train_batch`` cuts the
  batch into ``accumulate_steps`` microbatches and runs this stage's ops
  of the strategy's schedule (``schedule_mode``: FThenB, 1F1B (default) or
  Eager1F1B; interleaved over the model's virtual stages) through
  ``distributed.pipeline.run_schedule``, then sums the grads of weights
  shared by stages, averages the grads over the dp group, steps the
  optimizer and returns the mean loss on every stage. It drives a
  ``PipelineLayer`` or a model built under pp > 1 that keeps only its
  stage (Llama: ``pipeline_forward`` / ``pipeline_loss``). Over dp > 1
  the stage is wrapped in ``DataParallel``, whose reducer runs once at
  the end of the schedule (the microbatches' backwards run under
  ``no_sync()``): it leaves the experts of an expert-parallel layer to
  their all-to-alls, as it does without the pipeline;
- ``ShardingParallel`` raises: ZeRO is ROADMAP.md A8(d).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from ...nn.layer_base import Layer
from .. import collective as C
from ..parallel import DataParallel
from ..pipeline import microbatch, run_schedule, schedule_ops
from ..pp_schedules import resolve_schedule_mode
from ..topology import HybridCommunicateGroup


class MetaParallelBase(Layer):
    def __init__(self, layers, hcg: HybridCommunicateGroup, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_layers"], name)


class TensorParallel(MetaParallelBase):
    """The model as it is: its mp layers carry their collectives."""


class ShardingParallel(MetaParallelBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ShardingParallel (ZeRO) is ROADMAP.md "
                                  "A8(d)")


class SegmentParallel(MetaParallelBase):
    """Sequence parallelism over the sep group (module docstring)."""

    def __init__(self, layers, hcg: HybridCommunicateGroup, strategy=None):
        super().__init__(layers, hcg, strategy)
        self.sep_group = hcg.get_sep_parallel_group()
        group = hcg.get_dp_sep_parallel_group()
        if group.nranks > 1:
            self._layers = DataParallel(layers, group=group)

    def chunk(self, t):
        """This sep rank's chunk of dim 1 of ``t`` (other values as they
        are)."""
        if not isinstance(t, torch.Tensor) or t.dim() < 2:
            return t
        n = self.sep_group.nranks
        if t.shape[1] % n:
            raise ValueError(f"sequence length {t.shape[1]} does not divide "
                             f"over {n} sep ranks")
        per = t.shape[1] // n
        return t[:, self.sep_group.rank * per:(self.sep_group.rank + 1) * per]

    def forward(self, *inputs, **kwargs):
        inputs = tuple(self.chunk(t) for t in inputs)
        kwargs = {k: self.chunk(v) for k, v in kwargs.items()}
        return self._layers(*inputs, **kwargs)


class PipelineParallel(MetaParallelBase):
    """Drives the model's stage through the pipeline schedule (module
    docstring). ``stats`` holds the last step's ``recv_wait_s`` (time
    blocked in receives), ``busy_s`` (the schedule's wall time) and
    ``step_s``."""

    def __init__(self, layers, hcg: HybridCommunicateGroup, strategy=None,
                 schedule: Optional[str] = None):
        super().__init__(layers, hcg, strategy)
        cfg = strategy.pipeline_configs if strategy is not None else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1) or 1)
        self.schedule = schedule or resolve_schedule_mode("1F1B")
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.stage = hcg.get_stage_id()
        self.group = hcg.get_pipe_parallel_group()
        self.dp_group = hcg.get_data_parallel_group()
        if self.dp_group.nranks > 1:
            self._layers = DataParallel(layers, group=self.dp_group)
        self.stats = {}

    def _run(self, data, train: bool):
        inputs, labels = data
        if isinstance(inputs, (list, tuple)):
            inputs = inputs[0]
        M = self.accumulate_steps
        model = self._layers
        v = int(model.pipeline_chunks())
        S = self.num_stages
        ops = schedule_ops(S, M, v, self.schedule, train=train)
        x_mb = list(microbatch(inputs, M).unbind(0))
        y_mb = None if labels is None else list(microbatch(labels, M)
                                               .unbind(0))
        return run_schedule(model.pipeline_forward, model.pipeline_loss,
                            x_mb, y_mb, ops, self.stage, S, v, self.group,
                            train=train,
                            device=next(iter(model.parameters())).device)

    def _mean_loss(self, loss, device) -> torch.Tensor:
        """The last stage's mean loss, on every stage of the group."""
        if self.num_stages == 1:
            return loss
        t = loss.reshape(1).clone() if loss is not None else \
            torch.zeros(1, dtype=torch.float32, device=device)
        C.all_reduce(t, group=self.group)
        return t.reshape(())

    def forward_backward_pipeline(self, data, scaler=None):
        """One forward and backward over every microbatch; returns the
        mean loss (on every stage). The grads are on the stage's
        parameters."""
        if scaler is not None:
            raise NotImplementedError("a GradScaler under the pipeline")
        t0 = time.perf_counter()
        model = self._layers
        dp = isinstance(model, DataParallel)
        with model.no_sync() if dp else contextlib.nullcontext():
            res = self._run(data, train=True)
        if hasattr(model, "allreduce_shared_weight_gradients"):
            model.allreduce_shared_weight_gradients()
        if dp:
            model.sync_grads()
        dev = next(iter(model.parameters())).device
        loss = self._mean_loss(res["loss"], dev)
        self.stats = {"recv_wait_s": res["recv_wait_s"],
                      "busy_s": res["busy_s"],
                      "step_s": time.perf_counter() - t0}
        return loss

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        loss = self.forward_backward_pipeline(data, scaler)
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss: bool = True):
        """The mean loss over the microbatches (every stage), or with
        ``compute_loss=False`` the last stage's outputs, concatenated (None
        on the other stages)."""
        inputs, labels = data
        with torch.no_grad():
            res = self._run((inputs, labels if compute_loss else None),
                            train=False)
        if compute_loss:
            dev = next(iter(self._layers.parameters())).device
            return self._mean_loss(res["loss"], dev)
        outs = res["outputs"]
        return torch.cat([outs[m] for m in sorted(outs)]) if outs else None
