"""The graph-learning ops: message passing, neighbour sampling, reindexing.

Counterparts of ``paddle_tpu/ops/kernels/graph.py:35-200`` (``ops.yaml``
lines 680-685; the RNN-T loss of that module lives in ``rnn.py``).

Message passing gathers ``x[src]``, forms the message and reduces it at
``dst`` as the reference's ``_segment_reduce`` does: bf16, fp16 and
float32 messages accumulate in float32, rows that no edge reaches come out
0 under ``MAX`` and ``MIN``, ``MEAN`` divides by ``max(count, 1)``, and the
per-row ``count`` (int32) is returned. ``SUM`` and ``MEAN`` add with
``index_add`` (float32 atomics on the card: the last bits of a row that
many edges reach change from run to run, as a scatter-add's do), ``MAX``
and ``MIN`` reduce with ``scatter_reduce``. Without ``out_size`` the row
count is read on the host (``jit: false`` in the reference), which a
captured step cannot do.

The samplers and ``reindex_graph`` run on the host (numpy), as the
reference's do, and return on the input's device. Their draws come from
a numpy generator seeded from the port's CPU generator
(``core.generator``), so ``paddle_tpu_torch.seed`` makes them
reproducible; the draws are not the reference's (threefry).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.generator import default_generator
from ..dispatcher import register_kernel
from .manipulation import _not_captured

_LOW = (torch.bfloat16, torch.float16, torch.float32)


def _extreme(dtype, high: bool):
    info = torch.finfo(dtype) if dtype.is_floating_point else \
        torch.iinfo(dtype)
    return info.max if high else info.min


def segment_reduce(msg, dst, n: int, reduce_op: str):
    """``(out [n, ...], count [n] int32)``: the messages reduced at their
    destination rows."""
    acc = torch.float32 if msg.dtype in _LOW else msg.dtype
    m = msg.to(acc)
    shape = (n,) + tuple(msg.shape[1:])
    dst = dst.long()
    if reduce_op in ("SUM", "MEAN"):
        out = torch.zeros(shape, dtype=acc, device=msg.device).index_add(
            0, dst, m)
    elif reduce_op in ("MAX", "MIN"):
        high = reduce_op == "MIN"
        fill = _extreme(acc, high)
        idx = dst.reshape((-1,) + (1,) * (m.dim() - 1)).expand_as(m)
        out = torch.full(shape, fill, dtype=acc, device=msg.device) \
            .scatter_reduce(0, idx, m, "amin" if high else "amax")
        out = torch.where(out == fill, torch.zeros((), dtype=acc,
                                                   device=out.device), out)
    else:
        raise ValueError(f"reduce_op {reduce_op!r}")
    count = torch.bincount(dst, minlength=n)[:n].to(torch.int32)
    if reduce_op == "MEAN":
        div = count.clamp(min=1).to(acc if acc.is_floating_point
                                    else torch.float32)
        out = out / div.reshape((n,) + (1,) * (msg.dim() - 1))
    return out.to(msg.dtype), count


def _out_size(out_size, dst, name):
    if out_size is None or int(out_size) <= 0:
        _not_captured(name)
        return int(dst.max()) + 1 if dst.numel() else 0
    return int(out_size)


def _gather(x, index):
    """``x[index]`` along rows (its backward an ``index_add``)."""
    return torch.index_select(x, 0, index.long())


@register_kernel("send_u_recv")
def send_u_recv(x, src_index, dst_index, reduce_op="SUM", out_size=0):
    """``out[d]``: the reduction over the edges ``e`` with ``dst[e] == d``
    of ``x[src[e]]``."""
    n = _out_size(out_size, dst_index, "send_u_recv")
    return segment_reduce(_gather(x, src_index), dst_index, n,
                          reduce_op.upper())


def _message(a, b, message_op):
    return a + b if message_op.upper() == "ADD" else a * b


@register_kernel("send_ue_recv")
def send_ue_recv(x, y, src_index, dst_index, message_op="ADD",
                 reduce_op="SUM", out_size=0):
    """The message ``x[src] (ADD | MUL) y[edge]`` (``y`` broadcast against
    the gathered rows), reduced at ``dst``."""
    m = _gather(x, src_index)
    yy = y
    while yy.dim() < m.dim():
        yy = yy[..., None]
    m = _message(m, yy.to(m.dtype), message_op)
    n = _out_size(out_size, dst_index, "send_ue_recv")
    return segment_reduce(m, dst_index, n, reduce_op.upper())


@register_kernel("send_uv")
def send_uv(x, y, src_index, dst_index, message_op="ADD"):
    """Per edge: ``x[src] (ADD | MUL) y[dst]``, no reduction."""
    return _message(_gather(x, src_index), _gather(y, dst_index),
                    message_op)


# -- sampling and reindexing (host) ------------------------------------------------

def host_rng() -> np.random.Generator:
    """A numpy generator seeded from the port's CPU generator: each call
    advances it, so draws differ call to call and repeat under ``seed``."""
    g = default_generator(torch.device("cpu"))
    s = int(torch.randint(0, 2 ** 62, (), generator=g))
    return np.random.default_rng(s)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _sample(row, colptr, nodes, eids, return_eids, name, select):
    """Each node's chosen in-edges (``select(rng, lo, hi, deg)`` -> absolute
    edge indices): ``(neighbours, counts int32, edge ids)``."""
    _not_captured(name)
    if return_eids and eids is None:
        raise ValueError(f"return_eids=True requires eids (the {name} "
                         f"contract)")
    rows = _np(row).astype(np.int64)
    cp = _np(colptr).astype(np.int64)
    nds = _np(nodes).astype(np.int64).reshape(-1)
    ea = _np(eids).astype(np.int64) if return_eids else None
    rng = host_rng()
    picks = [select(rng, int(cp[v]), int(cp[v + 1]),
                    int(cp[v + 1] - cp[v])) for v in nds]
    idx = np.concatenate(picks) if picks else np.zeros(0, np.int64)
    cnt = np.asarray([len(p) for p in picks], np.int32)
    dev, dt = row.device, row.dtype
    oe = ea[idx] if ea is not None else np.zeros(0, np.int64)
    return (torch.from_numpy(rows[idx]).to(dev, dt),
            torch.from_numpy(cnt).to(dev),
            torch.from_numpy(oe).to(dev, dt))


@register_kernel("graph_sample_neighbors")
def graph_sample_neighbors(row, colptr, x, eids=None, perm_buffer=None,
                           sample_size=-1, return_eids=False,
                           flag_perm_buffer=False):
    """CSC sampling: each node of ``x`` keeps up to ``sample_size`` of its
    in-neighbours ``row[colptr[v]:colptr[v + 1]]``, uniformly without
    replacement (all of them where it has no more)."""
    k = int(sample_size)

    def select(rng, lo, hi, deg):
        if k < 0 or deg <= k:
            return np.arange(lo, hi)
        return lo + rng.choice(deg, size=k, replace=False)

    return _sample(row, colptr, x, eids, return_eids,
                   "graph_sample_neighbors", select)


@register_kernel("weighted_sample_neighbors")
def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              eids=None, sample_size=-1, return_eids=False):
    """Weighted sampling without replacement (A-Res: the top ``k`` keys
    ``u ** (1 / w)``), the reference's reservoir strategy."""
    w = _np(edge_weight).astype(np.float64).reshape(-1)
    k = int(sample_size)

    def select(rng, lo, hi, deg):
        idx = np.arange(lo, hi)
        if 0 <= k < deg:
            keys = rng.random(deg) ** (1.0 / np.maximum(w[lo:hi], 1e-12))
            idx = idx[np.argsort(-keys)[:k]]
        return idx

    return _sample(row, colptr, input_nodes, eids, return_eids,
                   "weighted_sample_neighbors", select)


def _first_seen(a: np.ndarray) -> np.ndarray:
    """The distinct values of ``a`` in the order of their first
    appearance."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


@register_kernel("reindex_graph")
def reindex_graph(x, neighbors, count, hashtable_value=None,
                  hashtable_index=None):
    """Relabel ``x`` and then the new neighbour nodes to dense local ids, in
    the order of first appearance: ``(src [E], dst [E], out_nodes)``, edge
    ``e`` of input node ``i`` running ``local(neighbors[e]) -> i``."""
    _not_captured("reindex_graph")
    xs = _np(x).astype(np.int64).reshape(-1)
    nb = _np(neighbors).astype(np.int64).reshape(-1)
    cnt = _np(count).astype(np.int64).reshape(-1)
    seeds = _first_seen(xs)
    fresh = nb[~np.isin(nb, seeds)]
    out_nodes = np.concatenate([seeds, _first_seen(fresh)])
    order = np.argsort(out_nodes, kind="stable")
    src = order[np.searchsorted(out_nodes[order], nb)]
    dst = np.repeat(np.arange(len(xs)), cnt)[:len(nb)]
    dev, dt = x.device, x.dtype
    return (torch.from_numpy(src).to(dev, dt),
            torch.from_numpy(dst).to(dev, dt),
            torch.from_numpy(out_nodes).to(dev, dt))
