"""Megatron-style sequence parallelism over the model-parallel group.

Counterpart of ``paddle_tpu/distributed/fleet/sequence_parallel_utils.py``.
Between the tensor-parallel blocks the activations are cut on the sequence
dim over the mp ranks. The reference's ops are sharding transitions that
GSPMD lowers to the collectives (:35-95); the port's rank holds its shard
and issues them itself, as upstream Paddle's ops do, in
``torch.autograd.Function``s:

- ``ScatterOp``: this rank's chunk of the sequence forward, all-gather of
  the grad backward;
- ``GatherOp`` / ``AllGatherOp``: all-gather forward, this rank's chunk of
  the grad backward (the gathered tensor feeds the same function on every
  rank);
- ``ReduceScatterOp``: the sum over the ranks, cut to this rank's chunk,
  forward; all-gather of the grad backward.

``ColumnSequenceParallelLinear`` (:92-117) all-gathers its sequence-cut
input forward and reduce-scatters the input's grad backward (each rank's
grad is the part its column shard gives); ``RowSequenceParallelLinear``
(:120-145) reduce-scatters its partial products onto the sequence dim
and adds its whole bias there.

``mark_as_sequence_parallel_parameter`` and
``register_sequence_parallel_allreduce_hooks`` (:148-160) are metadata
only in the reference, whose GSPMD reduces those grads. Here a parameter
used on a sequence shard only (a norm weight between the blocks, the row
linear's bias) gets the grad of its rank's shard, so the hooks are real:
after every ``accumulation_steps``-th backward that reaches it, its grad
is all-reduced over the mp group. Register them before
``fleet.distributed_model`` wraps the model, so that the sum is taken
before the data-parallel reducer reads the grad.

The sequence dim is 1 for ``[b, s, h]`` activations (0 for 2-D ones), as
the reference's ``axis=1 if x.ndim > 2 else 0``.
"""

from __future__ import annotations

import torch

from ...nn.layer_base import Layer
from ...ops.kernels import nn as K
from .. import collective as C
from .mp_layers import _cut, _distributed, _mp_group, gather_from_mp

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "scatter", "all_gather",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
    "mark_as_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks",
]


def _seq_axis(x: torch.Tensor, axis) -> int:
    return (1 if x.dim() > 2 else 0) if axis is None else axis


def _chunk(x: torch.Tensor, axis: int, group: C.Group) -> torch.Tensor:
    n = _cut(x.shape[axis], group, "sequence length")
    return x.narrow(axis, group.rank * n, n).contiguous()


def _gather(x: torch.Tensor, axis: int, group: C.Group) -> torch.Tensor:
    return torch.cat(C.all_gather([], x.contiguous(), group=group), dim=axis)


def _reduce_scatter(x: torch.Tensor, axis: int,
                    group: C.Group) -> torch.Tensor:
    moved = x.movedim(axis, 0).contiguous()
    n = _cut(moved.shape[0], group, "sequence length")
    out = torch.empty((n,) + moved.shape[1:], dtype=x.dtype, device=x.device)
    C.reduce_scatter(out, moved, group=group)
    return out.movedim(0, axis)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _chunk(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.axis, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _reduce_scatter(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.group), None, None


class _GatherForLinear(torch.autograd.Function):
    """All-gather forward; the grads of the gathered tensor differ by
    rank (each from its column shard), so the backward sums them and
    hands each rank its chunk: a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, axis, group):
        ctx.axis, ctx.group = axis, group
        return _gather(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.group), None, None


def scatter(x: torch.Tensor, axis=None, group=None) -> torch.Tensor:
    """This rank's chunk of the sequence (``ScatterOp``)."""
    return _Scatter.apply(x, _seq_axis(x, axis), _mp_group(group))


def all_gather(x: torch.Tensor, axis=None, group=None) -> torch.Tensor:
    """The whole sequence on every mp rank (``AllGatherOp``)."""
    return _Gather.apply(x, _seq_axis(x, axis), _mp_group(group))


def reduce_scatter(x: torch.Tensor, axis=None, group=None) -> torch.Tensor:
    """The sum over the mp ranks, cut to this rank's chunk."""
    return _ReduceScatter.apply(x, _seq_axis(x, axis), _mp_group(group))


class ScatterOp:
    @staticmethod
    def apply(x: torch.Tensor, axis=None, group=None) -> torch.Tensor:
        return scatter(x, axis, group)


class GatherOp:
    @staticmethod
    def apply(x: torch.Tensor, axis=None, group=None) -> torch.Tensor:
        return all_gather(x, axis, group)


class AllGatherOp(GatherOp):
    pass


class ReduceScatterOp:
    @staticmethod
    def apply(x: torch.Tensor, axis=None, group=None) -> torch.Tensor:
        return reduce_scatter(x, axis, group)


class ColumnSequenceParallelLinear(Layer):
    """``W [in, out / mp]``: the sequence-cut input is all-gathered, each
    rank computes its slice of the output features over the whole
    sequence (``gather_output=True`` all-gathers them)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.gather_output = gather_output
        per = _cut(out_features, self.group, "out_features")
        self.weight = _distributed(self.create_parameter(
            (in_features, per), attr=weight_attr))
        self.bias = None
        if has_bias:
            self.bias = _distributed(self.create_parameter(
                (per,), is_bias=True))

    def forward(self, x):
        x = _GatherForLinear.apply(x, _seq_axis(x, None), self.group)
        out = K.linear(x, self.weight, self.bias)
        return gather_from_mp(out, self.group) if self.gather_output else out


class RowSequenceParallelLinear(Layer):
    """``W [in / mp, out]``: the partial products over the whole sequence
    are reduce-scattered onto the sequence dim, then the whole bias
    (marked sequence-parallel) is added to the rank's chunk."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.input_is_parallel = input_is_parallel
        per = _cut(in_features, self.group, "in_features")
        self.weight = _distributed(self.create_parameter(
            (per, out_features), attr=weight_attr))
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter((out_features,), is_bias=True)
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if not self.input_is_parallel:
            n = x.shape[-1] // self.group.nranks
            x = x[..., self.group.rank * n:(self.group.rank + 1) * n]
        out = _ReduceScatter.apply(K.linear(x, self.weight),
                                   _seq_axis(x, None), self.group)
        return out if self.bias is None else out + self.bias


def mark_as_sequence_parallel_parameter(param: torch.Tensor) -> None:
    """Tag a parameter used on a sequence shard only: its grad is summed
    over the mp group by :func:`register_sequence_parallel_allreduce_hooks`."""
    param.sequence_parallel = True


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps:
                                               int = 1,
                                               fuse: bool = False) -> list:
    """All-reduce over the mp group the grad of every parameter of
    ``model`` marked sequence-parallel, after every
    ``accumulation_steps``-th backward that reaches it (``fuse`` is
    accepted: each grad is reduced alone). The hooks sit on the grad
    accumulators (a parameter with a tensor hook would leave the fused
    optimizer's route); returns the nodes, which the parameters keep."""
    params = [p for p in model.parameters()
              if getattr(p, "sequence_parallel", False) and p.requires_grad]
    if not params:
        return []
    group = _mp_group(None)
    nodes = []
    for p in params:
        node = torch.autograd.graph.get_gradient_edge(p).node
        seen = [0]

        def on_grad(*_, p=p, seen=seen):
            seen[0] += 1
            if seen[0] % accumulation_steps == 0 and p.grad is not None:
                C.all_reduce(p.grad, group=group)
        node.register_hook(on_grad)
        nodes.append(node)
        p._sp_allreduce_node = node     # a node lives while referenced
    return nodes
