"""Tensor-parallel (Megatron) layers.

Counterpart of ``paddle_tpu/distributed/fleet/mp_layers.py``:
``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``, ``ParallelCrossEntropy`` and
``tp_attention_context``. The reference's layers hold global weights with
a sharding and let GSPMD insert the collectives. The port's rank holds
only its shard and issues Megatron's collectives over the model-parallel
group itself, as upstream Paddle's ``mp_ops`` do. Four autograd
functions carry them:

- ``copy_to_mp``: identity forward, all-reduce of the grad backward;
- ``reduce_from_mp``: all-reduce forward, identity backward (``all_reduce``
  is the same function over any group and reduction, with or without an
  all-reduce of the grad backward: the sequence-parallel loss and the
  expert-parallel load-balance loss take it too);
- ``gather_from_mp``: all-gather of the last dim forward, the rank's
  slice of the grad backward;
- ``scatter_to_mp``: the rank's slice of the last dim forward, all-gather
  of the grad backward.

Weights keep Paddle's ``[in, out]`` layout. A column-parallel weight is
cut on ``out`` (its bias too), a row-parallel one on ``in`` (its bias is
whole and added after the all-reduce), the vocab-parallel table on rows:
each rank holds ``[r * n / mp, (r + 1) * n / mp)``. A cut parameter has
``is_distributed = True``, which the hybrid global-norm clip reads
(``fleet.distributed_optimizer``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...nn.layer_base import Layer
from ...ops.kernels import nn as K
from .. import collective as C
from ..topology import get_hybrid_communicate_group


def _hcg():
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("fleet.init(is_collective=True) must run before "
                           "tensor-parallel layers are built")
    return hcg


def _mp_group(group=None) -> C.Group:
    return group if group is not None else _hcg().get_model_parallel_group()


def tp_attention_context() -> Optional[Tuple[C.Group, int]]:
    """``(model-parallel group, its degree)`` under tensor parallelism,
    else None. The column-parallel q/k/v projections leave each rank its
    own heads, so attention needs no collective, and o_proj's all-reduce
    stays the block's only model-parallel exchange (the reference's
    ``(mesh, head_axis, batch_axis)``, :31-48)."""
    hcg = get_hybrid_communicate_group()
    if hcg is None or hcg.get_model_parallel_world_size() <= 1:
        return None
    return hcg.get_model_parallel_group(), \
        hcg.get_model_parallel_world_size()


def _all_reduce(x: torch.Tensor, group: C.Group,
                op: str = C.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().contiguous().clone()
    C.all_reduce(out.view(-1), op=op, group=group)
    return out


def _gather_last(x: torch.Tensor, group: C.Group) -> torch.Tensor:
    parts = C.all_gather([], x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _my_slice(x: torch.Tensor, group: C.Group) -> torch.Tensor:
    n = x.shape[-1] // group.nranks
    return x[..., group.rank * n:(group.rank + 1) * n].contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """All-reduce ``op`` forward. Backward the grad as it is, or with
    ``sum_grads`` its sum over the group: where every rank's objective is
    the reduced value, each rank's part gets every rank's grad."""

    @staticmethod
    def forward(ctx, x, group, op, sum_grads):
        ctx.group, ctx.sum_grads = group, sum_grads
        return _all_reduce(x, group, op)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group) if ctx.sum_grads else g
        return g, None, None, None


class _GatherFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.group), None


class _ScatterToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _my_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def copy_to_mp(x, group):
    return _CopyToMP.apply(x, group)


def reduce_from_mp(x, group):
    return _AllReduce.apply(x, group, C.ReduceOp.SUM, False)


def all_reduce(x: torch.Tensor, group: C.Group, op: str = C.ReduceOp.SUM,
               sum_grads: bool = False) -> torch.Tensor:
    """``x`` all-reduced over ``group``, differentiable (``_AllReduce``)."""
    return _AllReduce.apply(x, group, op, sum_grads)


def gather_from_mp(x, group):
    return _GatherFromMP.apply(x, group)


def scatter_to_mp(x, group):
    return _ScatterToMP.apply(x, group)


def _cut(n: int, group: C.Group, what: str) -> int:
    if n % group.nranks:
        raise ValueError(f"{what} {n} does not divide over the "
                         f"{group.nranks} model-parallel ranks")
    return n // group.nranks


def _distributed(p):
    if p is not None:
        p.is_distributed = True
    return p


class VocabParallelEmbedding(Layer):
    """The table's rows cut over the model-parallel ranks: each looks up
    the ids in its range (the others give zeros), then an all-reduce."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.per_rank = _cut(num_embeddings, self.group, "num_embeddings")
        self.start = self.group.rank * self.per_rank
        self.weight = _distributed(self.create_parameter(
            (self.per_rank, embedding_dim), attr=weight_attr))

    def forward(self, x):
        local = x - self.start
        outside = (local < 0) | (local >= self.per_rank)
        out = K.embedding(torch.where(outside, 0, local), self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return reduce_from_mp(out, self.group)


class ColumnParallelLinear(Layer):
    """``W [in, out / mp]``: each rank computes its slice of the output
    (``gather_output=True`` all-gathers it). The input's grad is
    all-reduced over the ranks."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 bias_attr=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        per = _cut(out_features, self.group, "out_features")
        self.weight = _distributed(self.create_parameter(
            (in_features, per), attr=weight_attr))
        self.bias = None
        if has_bias:
            self.bias = _distributed(self.create_parameter(
                (per,), is_bias=True, attr=bias_attr))

    def forward(self, x):
        out = K.linear(copy_to_mp(x, self.group), self.weight, self.bias)
        return gather_from_mp(out, self.group) if self.gather_output else out


class RowParallelLinear(Layer):
    """``W [in / mp, out]``: each rank multiplies its slice of the input
    (``input_is_parallel=False`` takes the slice first), the partial
    products are all-reduced, then the whole bias is added."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 bias_attr=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        per = _cut(in_features, self.group, "in_features")
        self.weight = _distributed(self.create_parameter(
            (per, out_features), attr=weight_attr))
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter((out_features,), is_bias=True,
                                              attr=bias_attr)

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_mp(x, self.group)
        out = reduce_from_mp(K.linear(x, self.weight), self.group)
        return out if self.bias is None else out + self.bias


class _VocabParallelCE(torch.autograd.Function):
    """Cross entropy over logits whose class dim is cut over the ranks:
    the max, the sum of exponentials and the picked logit are each
    all-reduced; the grad is ``softmax - onehot`` on the rank's slice."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        x = logits.float()
        per = x.shape[-1]
        start = group.rank * per
        m = x.amax(dim=-1, keepdim=True)
        C.all_reduce(m, op=C.ReduceOp.MAX, group=group)
        e = torch.exp(x - m)
        s = e.sum(dim=-1, keepdim=True)
        C.all_reduce(s, group=group)
        lab = label.long().reshape(x.shape[:-1] + (1,))
        local = lab - start
        inside = (local >= 0) & (local < per)
        picked = torch.where(inside, x.gather(
            -1, torch.where(inside, local, 0)), 0.0)
        C.all_reduce(picked, group=group)
        valid = lab != ignore_index
        loss = torch.where(valid, torch.log(s) + m - picked, 0.0)
        ctx.save_for_backward(e / s, local, inside & valid, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        p, local, hit, valid = ctx.saved_tensors
        grad = p.clone()
        grad.scatter_add_(-1, torch.where(hit, local, 0),
                          torch.where(hit, -1.0, 0.0))
        grad = torch.where(valid, grad * g.float(), 0.0)
        return grad.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(Layer):
    """Per-position cross entropy ``[..., 1]`` over logits cut on the class
    dim (the column-parallel head with ``gather_output=False``)."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return _VocabParallelCE.apply(input, label, self.group,
                                      self.ignore_index)
