"""paddle.geometric: message passing, neighbour sampling and reindexing.

Counterpart of ``paddle_tpu/geometric/__init__.py``, over the registry's
graph ops (``ops/kernels/graph.py``): the reduce and message names are
case-free, ``out_size=None`` sizes the output by the largest
destination. Each keeps the boundary rule (``core.tensor.paddle_call``:
``Tensor`` in, ``Tensor`` out; torch in, torch out).
"""

from ..core.tensor import paddle_call
from ..ops.dispatcher import get_op

__all__ = ["send_u_recv", "send_ue_recv", "send_uv", "sample_neighbors",
           "weighted_sample_neighbors", "reindex_graph"]


def _call(name, *args, **kwargs):
    return paddle_call(get_op(name), args, kwargs)


def _size(out_size):
    return 0 if out_size is None else int(out_size)


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """``out[d]``: the reduction (sum, mean, max, min) of ``x[src[e]]`` over
    the edges ``e`` with ``dst[e] == d``."""
    out, _ = _call("send_u_recv", x, src_index, dst_index,
                   reduce_op=reduce_op.upper(), out_size=_size(out_size))
    return out


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """As :func:`send_u_recv` over the messages ``x[src] (add | mul)
    y[edge]``."""
    out, _ = _call("send_ue_recv", x, y, src_index, dst_index,
                   message_op=message_op.upper(),
                   reduce_op=reduce_op.upper(), out_size=_size(out_size))
    return out


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per edge: ``x[src] (add | mul) y[dst]``."""
    return _call("send_uv", x, y, src_index, dst_index,
                 message_op=message_op.upper())


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Up to ``sample_size`` in-neighbours of each input node (CSC ``row``
    / ``colptr``), uniformly without replacement: ``(neighbours, counts[,
    edge ids])``."""
    out, cnt, oe = _call("graph_sample_neighbors", row, colptr, input_nodes,
                         eids, perm_buffer, sample_size=sample_size,
                         return_eids=return_eids)
    return (out, cnt, oe) if return_eids else (out, cnt)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    """As :func:`sample_neighbors`, each edge drawn by its weight."""
    out, cnt, oe = _call("weighted_sample_neighbors", row, colptr,
                         edge_weight, input_nodes, eids,
                         sample_size=sample_size, return_eids=return_eids)
    return (out, cnt, oe) if return_eids else (out, cnt)


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """``(src, dst, out_nodes)``: the sampled edges over dense local ids."""
    return _call("reindex_graph", x, neighbors, count, value_buffer,
                 index_buffer)
