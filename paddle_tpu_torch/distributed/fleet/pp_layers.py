"""PipelineLayer / LayerDesc: describing a model for the pipeline.

Counterpart of ``paddle_tpu/distributed/fleet/pp_layers.py``
(``LayerDesc`` :27, ``SharedLayerDesc`` :44, ``PipelineLayer`` :59). The
reference builds every layer (one program over the mesh) and pipelines
the longest run of like descriptors as a ``LayerStack``, the layers
before and after it replicated over pp. The port is one process per
stage, as upstream Paddle's ``PipelineLayer`` is: each rank builds only
its own layers.

The descriptors split as the reference's: the head (before the longest
run of like ``LayerDesc``s), the run, the tail. The run is cut into ``S *
v`` equal chunks (``S`` stages, ``v`` virtual stages a stage,
``num_virtual_pipeline_stages`` or the strategy's ``virtual_pp_degree``);
chunk ``c`` lives on stage ``c % S``; the head goes before chunk 0 (stage
0) and the tail after the last chunk (the last stage), where the
reference keeps them outside the pipeline (ROADMAP.md §C).

A ``SharedLayerDesc`` key is built once on each stage that uses it; at
construction its ``shared_weight_attr`` is broadcast from the first of
those stages over a group of them, and
:meth:`PipelineLayer.allreduce_shared_weight_gradients` sums its grad over
that group after a backward (the reference's GSPMD does that sum; upstream
Paddle's ``allreduce_shared_weight_gradients``).
The copies on later stages are marked ``pipeline_shared_copy``, so the
hybrid global-norm clip counts the weight once.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from ...nn.layer_base import Layer
from .. import collective as C
from ..topology import AXIS_ORDER, get_hybrid_communicate_group


class LayerDesc:
    """Deferred layer construction (reference :27)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, nn.Module)):
            raise TypeError(f"{layer_cls} must be an nn.Module class")

    def build_layer(self) -> nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared by the positions with the same ``key`` (tied input
    and output embeddings, reference :44); ``forward_func(layer, x)``, if
    given, is how a position calls it."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _desc_key(d):
    """Stackability key: same class and constructor arguments."""
    if not isinstance(d, LayerDesc) or isinstance(d, SharedLayerDesc):
        return None
    return (d.layer_cls, repr(d.args), repr(sorted(d.kwargs.items())))


def longest_desc_run(descs) -> tuple:
    """``(start, length)`` of the longest run of like ``LayerDesc``s."""
    best = (0, 0)
    i = 0
    while i < len(descs):
        j = i
        key = _desc_key(descs[i])
        if key is not None:
            while j < len(descs) and _desc_key(descs[j]) == key:
                j += 1
        else:
            j = i + 1
        if j - i > best[1]:
            best = (i, j - i)
        i = j
    return best


class _Call(nn.Module):
    """One position of a chunk: a layer, and how it is called."""

    def __init__(self, layer: nn.Module, forward_func=None):
        super().__init__()
        self.layer = layer
        self.forward_func = forward_func

    def forward(self, x):
        if self.forward_func is not None:
            return self.forward_func(self.layer, x)
        return self.layer(x)


class PipelineLayer(Layer):
    """The stage's part of a model described by ``layers`` (``nn.Module``s
    and descriptors), for ``PipelineParallel``.

    ``num_stages`` defaults to the hybrid pp degree; ``loss_fn(out,
    label)`` is the criterion of ``train_batch``; ``recompute_interval >
    0`` recomputes each layer's activations in the backward
    (``distributed.recompute``)."""

    def __init__(self, layers: Sequence[Union[nn.Module, LayerDesc]],
                 num_stages: Optional[int] = None,
                 loss_fn: Optional[Callable] = None, topology=None,
                 seg_method: str = "uniform", recompute_interval: int = 0,
                 num_virtual_pipeline_stages: Optional[int] = None,
                 **kwargs):
        super().__init__()
        hcg = get_hybrid_communicate_group()
        S = int(num_stages or (hcg.get_pipe_parallel_world_size()
                               if hcg is not None else 1))
        if num_virtual_pipeline_stages is None:
            from . import get_strategy
            st = get_strategy()
            num_virtual_pipeline_stages = 1 if st is None else int(
                st.pipeline_configs.get("virtual_pp_degree", 1) or 1)
        v = int(num_virtual_pipeline_stages)
        self.num_stages, self.num_virtual = S, v
        self.stage = hcg.get_stage_id() if hcg is not None and S > 1 else 0
        self.loss_fn = loss_fn
        self._recompute = recompute_interval > 0
        descs = list(layers)
        start, length = longest_desc_run(descs)
        K = S * v
        if length % K:
            raise ValueError(f"pipelined segment has {length} layers, not "
                             f"divisible by {S} stages x {v} virtual stages")
        per = length // K
        chunks = [list(descs[start + c * per:start + (c + 1) * per])
                  for c in range(K)]
        chunks[0] = list(descs[:start]) + chunks[0]
        chunks[-1] = chunks[-1] + list(descs[start + length:])
        self.local_chunks = [j * S + self.stage for j in range(v)]
        shared = {}
        self.chunks = nn.ModuleList()
        for c in self.local_chunks:
            calls = []
            for d in chunks[c]:
                if isinstance(d, SharedLayerDesc):
                    if d.layer_name not in shared:
                        shared[d.layer_name] = d.build_layer()
                    calls.append(_Call(shared[d.layer_name], d.forward_func))
                elif isinstance(d, LayerDesc):
                    calls.append(_Call(d.build_layer()))
                else:
                    calls.append(_Call(d))
            self.chunks.append(nn.ModuleList(calls))
        self._shared = self._share_weights(descs, chunks, shared, hcg)

    def _share_weights(self, descs, chunks, built, hcg):
        """``{key: (weight, group)}`` for each shared key this stage holds
        that another stage holds too; equal weights from the first."""
        out = {}
        if hcg is None or self.num_stages == 1 or not C.is_initialized():
            return out
        keys = sorted({d.layer_name for d in descs
                       if isinstance(d, SharedLayerDesc)}, key=str)
        attrs = {d.layer_name: d.shared_weight_attr for d in descs
                 if isinstance(d, SharedLayerDesc)}
        topo = hcg.topology()
        others = [n for n in AXIS_ORDER if n != "pipe"]
        grid = [range(topo.get_dim(n)) for n in others]
        for key in keys:
            stages = sorted({c % self.num_stages for c, ch in
                             enumerate(chunks) for d in ch
                             if isinstance(d, SharedLayerDesc)
                             and d.layer_name == key})
            if len(stages) < 2:
                continue
            for coord in itertools.product(*grid):
                where = dict(zip(others, coord))
                ranks = [topo.get_rank(pipe=st, **where) for st in stages]
                group = C.new_group(ranks, axis="shared")
                if hcg.get_global_rank() not in ranks:
                    continue
                w = getattr(built[key], attrs[key])
                with torch.no_grad():
                    C.broadcast(w.data, src=ranks[0], group=group)
                if self.stage != stages[0]:
                    w.pipeline_shared_copy = True
                out[key] = (w, group)
        return out

    def get_num_of_stages(self) -> int:
        return self.num_stages

    def pipeline_chunks(self) -> int:
        return self.num_virtual

    def pipeline_forward(self, x, chunk: int):
        """This stage's local chunk ``chunk`` (global ``chunk * S +
        stage``)."""
        for call in self.chunks[chunk]:
            if self._recompute and self.training and torch.is_grad_enabled():
                from ..recompute import recompute
                x = recompute(call, x)
            else:
                x = call(x)
        return x

    def pipeline_loss(self, out, label):
        if self.loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for training")
        return self.loss_fn(out, label)

    def allreduce_shared_weight_gradients(self) -> None:
        for w, group in self._shared.values():
            if w.grad is None:
                w.grad = torch.zeros_like(w)
            C.all_reduce(w.grad, group=group)

    def forward(self, x, *args):
        """The whole model, on one stage only."""
        if self.num_stages > 1:
            raise RuntimeError("a PipelineLayer over several stages runs "
                               "through fleet.distributed_model(...)"
                               ".train_batch / .eval_batch")
        for j in range(self.num_virtual):
            x = self.pipeline_forward(x, j)
        return x
