"""The port's graph-learning ops (``ops/kernels/graph.py``) and
``paddle_tpu_torch.geometric`` against the JAX package's, on the CPU.

Message passing (``send_u_recv``, ``send_ue_recv``, ``send_uv``) through
``tests/_torch_op_check.py``, forward and VJP, within float32's limit
(atol / rtol 1e-5: the sums run in another order); the integer reductions
exactly; the ``count`` output; bf16 messages accumulating in float32.

The samplers draw from the port's generator, not threefry, so they are
held by support: every sampled neighbour is an in-neighbour of its node,
a node keeps ``min(deg, sample_size)`` of them, none twice, the edge ids
match the neighbours; and by reproducibility: ``paddle_tpu_torch.seed``
gives the same draws twice. ``reindex_graph`` is exact.
"""

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core.tensor import Tensor as RTensor
from paddle_tpu_torch import geometric
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp

from _torch_op_check import check_op

F32 = dict(atol=1e-5, rtol=1e-5)
N, E, D = 12, 40, 5


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _graph(seed=0, n=N, e=E):
    r = np.random.RandomState(seed)
    src = r.randint(0, n, e).astype(np.int64)
    dst = r.randint(0, n - 2, e).astype(np.int64)    # rows n-2, n-1 unreached
    return src, dst


def _x(seed=1, shape=(N, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


SRC, DST = _graph()


@pytest.mark.parametrize("reduce_op", ["SUM", "MEAN", "MAX", "MIN"])
@pytest.mark.parametrize("out_size", [0, N + 3])
def test_send_u_recv(reduce_op, out_size):
    check_op("send_u_recv", [_x(), SRC, DST],
             dict(reduce_op=reduce_op, out_size=out_size), **F32)


@pytest.mark.parametrize("message_op", ["ADD", "MUL"])
@pytest.mark.parametrize("reduce_op", ["SUM", "MEAN", "MAX", "MIN"])
def test_send_ue_recv(message_op, reduce_op):
    w = np.random.RandomState(2).rand(E).astype(np.float32)
    check_op("send_ue_recv", [_x(), w, SRC, DST],
             dict(message_op=message_op, reduce_op=reduce_op, out_size=N),
             **F32)


def test_send_ue_recv_vector_edges():
    y = np.random.RandomState(3).randn(E, D).astype(np.float32)
    check_op("send_ue_recv", [_x(), y, SRC, DST],
             dict(message_op="MUL", reduce_op="SUM"), **F32)


@pytest.mark.parametrize("message_op", ["ADD", "MUL"])
def test_send_uv(message_op):
    check_op("send_uv", [_x(), _x(4), SRC, DST],
             dict(message_op=message_op), **F32)


@pytest.mark.parametrize("reduce_op", ["SUM", "MAX", "MIN"])
def test_send_u_recv_integers_exact(reduce_op):
    x = np.random.RandomState(5).randint(-50, 50, (N, 3)).astype(np.int32)
    check_op("send_u_recv", [x, SRC, DST], dict(reduce_op=reduce_op),
             atol=0, rtol=0)


def test_bf16_messages_accumulate_in_float32():
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    out, count = tdisp.call_op("send_u_recv", x, torch.from_numpy(SRC),
                               torch.from_numpy(DST), reduce_op="MEAN")
    assert out.dtype == torch.bfloat16
    want = np.zeros((N - 2, D), np.float32)
    np.add.at(want, DST, x.float().numpy()[SRC])
    cnt = np.bincount(DST, minlength=N - 2)
    want /= np.maximum(cnt, 1)[:, None]
    np.testing.assert_allclose(out.float().numpy(), want.astype(
        np.float32), atol=1e-2, rtol=1e-2)
    np.testing.assert_array_equal(count.numpy(), cnt)
    assert count.dtype == torch.int32


def test_geometric_api_matches_the_reference():
    x, y = _x(), np.random.RandomState(2).rand(E).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, SRC, DST)]
    r = [RTensor(a) for a in (x, SRC, DST)]
    got = geometric.send_u_recv(*t, reduce_op="mean", out_size=N)
    want = paddle_tpu.geometric.send_u_recv(*r, reduce_op="mean",
                                            out_size=N)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    got = geometric.send_ue_recv(t[0], torch.from_numpy(y), t[1], t[2],
                                 message_op="mul", reduce_op="max")
    want = paddle_tpu.geometric.send_ue_recv(r[0], RTensor(y), r[1], r[2],
                                             message_op="mul",
                                             reduce_op="max")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    got = geometric.send_uv(t[0], t[0], t[1], t[2], message_op="mul")
    assert type(got) is torch.Tensor and tuple(got.shape) == (E, D)
    # Paddle in, Paddle out
    pt = paddle_tpu_torch.to_tensor(x)
    assert isinstance(geometric.send_u_recv(pt, t[1], t[2]),
                      paddle_tpu_torch.Tensor)
    assert sorted(geometric.__all__) == sorted(
        paddle_tpu.geometric.__all__)


# -- sampling and reindexing ------------------------------------------------------

def _csc(seed=0, n=30, e=200):
    r = np.random.RandomState(seed)
    src = r.randint(0, n, e)
    dst = r.randint(0, n, e)
    order = np.argsort(dst, kind="stable")
    row = src[order].astype(np.int64)
    colptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    return row, colptr.astype(np.int64), order.astype(np.int64)


def _check_support(row, colptr, nodes, k, out, cnt, eids=None, perm=None):
    out, cnt = out.numpy(), cnt.numpy()
    at = 0
    for v, c in zip(nodes, cnt):
        lo, hi = colptr[v], colptr[v + 1]
        deg = hi - lo
        assert c == (deg if k < 0 else min(deg, k))
        picked = out[at:at + c]
        assert set(picked.tolist()) <= set(row[lo:hi].tolist())
        if eids is not None:
            e = eids.numpy()[at:at + c]
            assert len(set(e.tolist())) == c           # no edge twice
            np.testing.assert_array_equal(row[[np.where(perm == x)[0][0]
                                               for x in e]], picked)
        at += c
    assert at == len(out)


@pytest.mark.parametrize("k", [-1, 3, 100])
def test_sample_neighbors_support(k):
    row, colptr, perm = _csc()
    nodes = np.array([0, 5, 7, 29, 5], np.int64)
    out, cnt, eids = tdisp.call_op(
        "graph_sample_neighbors", torch.from_numpy(row),
        torch.from_numpy(colptr), torch.from_numpy(nodes),
        torch.from_numpy(perm), sample_size=k, return_eids=True)
    _check_support(row, colptr, nodes, k, out, cnt, eids, perm)
    assert cnt.dtype == torch.int32 and out.dtype == torch.int64


def test_weighted_sample_neighbors_support():
    row, colptr, perm = _csc(1)
    w = np.random.RandomState(2).rand(len(row)).astype(np.float32) + 0.01
    nodes = np.arange(30, dtype=np.int64)
    out, cnt, eids = geometric.weighted_sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr), torch.from_numpy(w),
        torch.from_numpy(nodes), sample_size=4,
        eids=torch.from_numpy(perm), return_eids=True)
    _check_support(row, colptr, nodes, 4, out, cnt, eids, perm)


def test_weighted_sampling_follows_the_weights():
    # one node, two in-edges: weight 1000 against 0.001
    row = np.array([3, 4], np.int64)
    colptr = np.array([0, 0, 2, 2, 2, 2], np.int64)
    w = np.array([1000.0, 0.001], np.float32)
    paddle_tpu_torch.seed(1)
    hits = sum(int(geometric.weighted_sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr), torch.from_numpy(w),
        torch.tensor([1]), sample_size=1)[0][0]) == 3 for _ in range(50))
    assert hits >= 48


def test_samplers_reproduce_under_seed():
    row, colptr, _ = _csc(2)
    args = (torch.from_numpy(row), torch.from_numpy(colptr),
            torch.arange(30))

    def draw():
        return [geometric.sample_neighbors(*args, sample_size=2)[0]
                for _ in range(2)]
    paddle_tpu_torch.seed(7)
    a = draw()
    paddle_tpu_torch.seed(7)
    b = draw()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert not np.array_equal(a[0].numpy(), a[1].numpy())   # calls differ


def test_reference_samples_the_same_support():
    row, colptr, _ = _csc(3)
    nodes = np.array([1, 2, 3], np.int64)
    r_out, r_cnt = paddle_tpu.geometric.sample_neighbors(
        RTensor(row), RTensor(colptr), RTensor(nodes), sample_size=2)
    out, cnt = geometric.sample_neighbors(
        torch.from_numpy(row), torch.from_numpy(colptr),
        torch.from_numpy(nodes), sample_size=2)
    np.testing.assert_array_equal(cnt.numpy(), r_cnt.numpy())


def test_sampler_needs_eids_for_return_eids():
    row, colptr, _ = _csc()
    with pytest.raises(ValueError):
        tdisp.call_op("graph_sample_neighbors", torch.from_numpy(row),
                      torch.from_numpy(colptr), torch.tensor([0]),
                      sample_size=2, return_eids=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_reindex_graph_exact(seed):
    r = np.random.RandomState(seed)
    x = r.choice(100, 6, replace=False).astype(np.int64)
    x = np.concatenate([x, x[:2]])                      # repeated seeds
    count = r.randint(0, 5, len(x)).astype(np.int32)
    nb = r.randint(0, 100, int(count.sum())).astype(np.int64)
    nb[:2] = x[3]                                       # a seed as neighbour
    check_op("reindex_graph", [x, nb, count], atol=0, rtol=0)
    got = geometric.reindex_graph(*[torch.from_numpy(a)
                                    for a in (x, nb, count)])
    assert all(type(g) is torch.Tensor for g in got)
