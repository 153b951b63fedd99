"""The round-3 compat tranche (``ops.yaml:689-715``,
``ops/kernels/compat_tranche.py``) against the JAX package's ops, on the
CPU, through ``tests/_torch_op_check.py``: one parametrised case an entry
(a few entries two or three), forward and, where the reference
differentiates the op, the VJP of the floating inputs.

Tolerances (float32): atol / rtol 1e-5; 1e-4 for ``margin_cross_entropy``
(a softmax over scale-64 logits) and ``lrn`` (a power of a window sum).
Integer outputs are compared by value (the port's are int64 where the
reference's are int32). ``graph_khop_sampler`` is compared exactly where
every neighbour is kept (``sample_sizes`` -1) and by its invariants where
it samples (the draws are not the reference's).
"""

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.ops import dispatcher as rdisp
import paddle_tpu_torch
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp

from _torch_op_check import check_op

EW = dict(atol=1e-5, rtol=1e-5)
LOOSE = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def normal(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def uniform(lo, hi, *shape, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def ints(lo, hi, *shape, seed=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int32)


def _graph():
    """A 12-node graph in CSC form: (row, colptr) and the edge ids."""
    rng = np.random.RandomState(3)
    src = rng.randint(0, 12, 40)
    dst = rng.randint(0, 12, 40)
    order = np.argsort(dst, kind="stable")
    colptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=12))])
    return (src[order].astype(np.int64), colptr.astype(np.int64),
            order.astype(np.int64))


def _cases():
    c = {}
    x4 = normal(2, 6, 3, 3)
    c["lrn"] = ("lrn", [x4], dict(n=5, k=2.0, alpha=1e-2, beta=0.75), LOOSE)
    c["lrn_nhwc"] = ("lrn", [normal(2, 3, 3, 6)], dict(
        n=3, data_format="NHWC"), LOOSE)
    c["multiplex"] = ("multiplex", [[normal(4, 3), normal(4, 3, seed=1),
                                     normal(4, 3, seed=2)],
                                    ints(0, 3, 4, 1)], {}, EW)
    c["fill_diagonal_tensor"] = ("fill_diagonal_tensor", [
        normal(4, 5), normal(4, seed=1)], dict(offset=1), EW)
    c["fill_diagonal_tensor_3d"] = ("fill_diagonal_tensor", [
        normal(2, 4, 3), normal(2, 3, seed=1)], dict(offset=-1, dim1=1,
                                                     dim2=2), EW)
    c["grad_add"] = ("grad_add", [normal(3, 4), normal(3, 4, seed=1)], {},
                     EW)
    c["fc"] = ("fc", [normal(2, 3, 4, 5), normal(20, 6, seed=1),
                      normal(6, seed=2)], dict(in_num_col_dims=2,
                                               activation_type="relu"), EW)
    c["fc_flat"] = ("fc", [normal(3, 4, 2), normal(8, 5, seed=1)], {}, EW)
    c["identity_loss_sum"] = ("identity_loss", [normal(3, 4)],
                              dict(reduction=0), EW)
    c["identity_loss_mean"] = ("identity_loss", [normal(3, 4)], {}, EW)
    c["identity_loss_none"] = ("identity_loss", [normal(3, 4)],
                               dict(reduction=2), EW)
    c["shuffle_channel"] = ("shuffle_channel", [normal(2, 6, 3, 3)],
                            dict(group=3), EW)
    c["soft_relu"] = ("soft_relu", [normal(3, 4) * 3], dict(threshold=2.0),
                      EW)
    c["partial_sum"] = ("partial_sum", [[normal(3, 6), normal(3, 6, seed=1)]],
                        dict(start_index=1, length=3), EW)
    c["bilinear"] = ("bilinear", [normal(4, 3), normal(4, 5, seed=1),
                                  normal(2, 3, 5, seed=2),
                                  normal(2, seed=3)], {}, EW)
    c["sequence_mask_op"] = ("sequence_mask_op", [ints(0, 7, 2, 3)], {}, EW)
    c["sequence_mask_op_len"] = ("sequence_mask_op", [ints(1, 5, 4)], dict(
        max_len=6, out_dtype="bool"), EW)
    c["number_count"] = ("number_count", [np.array(
        [[0, 3, 3, -1], [7, 2, 9, 3]], np.int32)], dict(upper_range=8), EW)
    c["seed_op"] = ("seed_op", [], dict(seed=1234), EW)
    c["full_batch_size_like"] = ("full_batch_size_like", [normal(5, 2)],
                                 dict(shape=[1, 3], value=2.5,
                                      dtype="float32", input_dim_idx=0,
                                      output_dim_idx=1), EW)
    c["row_conv"] = ("row_conv", [normal(2, 7, 4), normal(3, 4, seed=1)],
                     {}, EW)
    c["fused_elemwise_add_activation"] = (
        "fused_elemwise_add_activation", [normal(3, 4), normal(3, 4, seed=1)],
        dict(functor_list=["relu", "elementwise_add"]), EW)
    c["fused_elemwise_add_activation_binary_first"] = (
        "fused_elemwise_add_activation", [normal(3, 4), normal(3, 4, seed=1)],
        dict(functor_list=["elementwise_add", "sigmoid"]), EW)
    cos = uniform(-0.9, 0.9, 6, 10)
    lab = ints(0, 10, 6)
    cos[0, lab[0]] = 1.0               # the clip keeps its gradient finite
    c["margin_cross_entropy"] = ("margin_cross_entropy", [cos, lab], {},
                                 LOOSE)
    c["margin_cross_entropy_cosface"] = (
        "margin_cross_entropy", [cos, lab], dict(margin1=1.0, margin2=0.0,
                                                 margin3=0.35, scale=30.0),
        LOOSE)
    c["hsigmoid_loss"] = ("hsigmoid_loss", [
        normal(4, 3), ints(0, 6, 4), normal(5, 3, seed=1),
        normal(5, 1, seed=2)], dict(num_classes=6), EW)
    path = np.array([[0, 1, -1], [0, 2, 3], [0, 1, 4], [0, 2, -1]],
                    np.int32)
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 0]], np.int32)
    c["hsigmoid_loss_custom"] = ("hsigmoid_loss", [
        normal(4, 3), ints(0, 6, 4), normal(5, 3, seed=1), None, path,
        code], dict(num_classes=6), EW)
    row, colptr, eids = _graph()
    c["graph_khop_sampler"] = ("graph_khop_sampler", [
        row, colptr, np.array([1, 5, 1], np.int64), eids], dict(
        sample_sizes=[-1, -1], return_eids=True), EW)
    c["lars_momentum_op"] = ("lars_momentum_op", [
        normal(4, 5), normal(4, 5, seed=1) * 0.1, normal(4, 5, seed=2),
        np.array([0.1], np.float32)], dict(mu=0.9, lars_coeff=0.01), EW)
    c["lars_momentum_op_zero_grad"] = ("lars_momentum_op", [
        normal(4, 5), np.zeros((4, 5), np.float32), normal(4, 5, seed=2),
        np.array([0.1], np.float32)], {}, EW)
    c["share_data"] = ("share_data", [normal(3, 4)], {}, EW)
    c["depthwise_conv2d_transpose"] = ("depthwise_conv2d_transpose", [
        normal(2, 4, 5, 5), normal(4, 1, 3, 3, seed=1), normal(4, seed=2)],
        dict(stride=[2, 2], padding=[1, 1], output_padding=[1, 1]), EW)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry(case):
    name, args, kw, tol = CASES[case]
    check_op(name, args, kw, **tol)


def test_seed_op_reads_the_seed_that_was_set():
    paddle_tpu.seed(77)
    paddle_tpu_torch.seed(77)
    want = rdisp.call_op("seed_op").numpy()
    got = tdisp.call_op("seed_op")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 77


def test_margin_cross_entropy_grad_is_finite_at_aligned_target():
    cos = np.zeros((2, 5), np.float32)
    cos[:, 1] = 1.0
    t = torch.from_numpy(cos).requires_grad_(True)
    _, loss = tdisp.call_op("margin_cross_entropy", t,
                            torch.tensor([1, 1]))
    loss.sum().backward()
    assert bool(torch.isfinite(t.grad).all())


def test_khop_sampler_invariants_where_it_samples():
    """Sampling 2 then 2: every edge is a graph edge between local ids,
    the seeds come first in the seeds' order, no node twice, no more than
    2 edges a center a hop."""
    row, colptr, eids = _graph()
    seeds = np.array([1, 5, 9], np.int64)
    src, dst, nodes, rx, oe = tdisp.call_op(
        "graph_khop_sampler", torch.from_numpy(row),
        torch.from_numpy(colptr), torch.from_numpy(seeds),
        torch.from_numpy(eids), sample_sizes=[2, 2], return_eids=True)
    nodes, src, dst, oe = (t.numpy() for t in (nodes, src, dst, oe))
    assert list(nodes[:3]) == [1, 5, 9] and list(rx.numpy()) == [0, 1, 2]
    assert len(set(nodes.tolist())) == len(nodes)
    assert len(src) == len(dst) == len(oe)
    edge_dst = np.empty(40, np.int64)
    edge_dst[eids] = np.repeat(np.arange(12), np.diff(colptr))
    edge_src = np.empty(40, np.int64)
    edge_src[eids] = row
    assert (edge_src[oe] == nodes[src]).all()
    assert (edge_dst[oe] == nodes[dst]).all()
    per_center = np.bincount(dst, minlength=len(nodes))
    assert per_center.max() <= 4         # 2 a hop, a node in both hops


def test_hsigmoid_loss_returns_w():
    w = torch.from_numpy(normal(5, 3, seed=1))
    out = tdisp.call_op("hsigmoid_loss", torch.from_numpy(normal(4, 3)),
                        torch.tensor([0, 1, 2, 5]), w, num_classes=6)
    assert out[2] is w and out[0].shape == (4, 1) and out[1].shape == (4, 3)


def test_every_entry_has_a_case():
    from paddle_tpu_torch.ops.kernels import compat_tranche
    mine = {n for n, k in tdisp.KERNELS.items()
            if k.__module__ == compat_tranche.__name__}
    section = {"lrn", "multiplex", "fill_diagonal_tensor", "grad_add", "fc",
               "identity_loss", "shuffle_channel", "soft_relu",
               "partial_sum", "bilinear", "sequence_mask_op",
               "number_count", "seed_op", "full_batch_size_like",
               "row_conv", "fused_elemwise_add_activation",
               "margin_cross_entropy", "hsigmoid_loss",
               "graph_khop_sampler", "lars_momentum_op", "share_data",
               "depthwise_conv2d_transpose"}
    assert mine == section and len(section) == 22
    assert section - {v[0] for v in CASES.values()} == set()
    assert section <= set(dir(paddle_tpu_torch))
    # the reference's two other entries of the section came with the
    # random ops
    assert {"shuffle_batch", "uniform_random_batch_size_like"} <= \
        set(tdisp.KERNELS)
