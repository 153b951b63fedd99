"""The rest of the extended tranche (``ops.yaml:438-494``, the new entries
of ``ops/kernels/math_ext.py``) and the round-2 math tranche
(``ops.yaml:496-543``, ``ops/kernels/extra_math.py``) against the JAX
package's ops, on the CPU, through ``tests/_torch_op_check.py``: one
parametrised case an entry (a few entries two), forward and, where the
reference differentiates the op, the VJP of the floating inputs.

Tolerances (float32): atol / rtol 1e-5, 1e-4 for the norms and ``cdist``
whose roots amplify the last bits of a sum. Integer outputs are compared
by value (the port's are int64 where the reference's are int32).
"""

import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor as RTensor
from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp

from _torch_op_check import check_op

EW = dict(atol=1e-5, rtol=1e-5)
NORM = dict(atol=1e-4, rtol=1e-4)


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


X34 = normal(3, 4)


def _cases():
    c = {}
    # the extended tranche
    nanx = X34.copy()
    nanx[0, 1] = nanx[2, 3] = np.nan
    c["nanquantile"] = ("nanquantile", [nanx], dict(q=0.3, axis=1), EW)
    c["nanquantile_keep"] = ("nanquantile", [nanx], dict(
        q=[0.25, 0.75], axis=0, keepdim=True, interpolation="nearest"), EW)
    c["nanquantile_lower"] = ("nanquantile", [nanx], dict(
        q=0.4, interpolation="lower"), EW)
    c["vander"] = ("vander", [normal(4)], dict(n=5), EW)
    c["vander_increasing"] = ("vander", [normal(3)], dict(increasing=True),
                              EW)
    c["trapezoid"] = ("trapezoid", [X34], dict(dx=0.5), EW)
    c["trapezoid_x"] = ("trapezoid", [X34, np.sort(normal(4, seed=1))],
                        dict(axis=-1), EW)
    c["polar"] = ("polar", [uniform(0.5, 2, 3, 4), X34], {}, EW)
    c["cdist"] = ("cdist", [normal(2, 5, 3), normal(2, 4, 3, seed=1)], {},
                  NORM)
    c["cdist_p1"] = ("cdist", [normal(5, 3), normal(4, 3, seed=1)],
                     dict(p=1.0), NORM)
    c["crop"] = ("crop", [normal(4, 5, 6)], dict(shape=[2, -1, 3],
                                                 offsets=[1, 2, 0]), EW)
    c["block_diag"] = ("block_diag", [[normal(2, 3), normal(1, 2, seed=1),
                                       normal(3, 3, seed=2)]], {}, EW)
    c["broadcast_tensors"] = ("broadcast_tensors", [[
        normal(3, 1), normal(1, 4, seed=1), normal(4, seed=2)]], {}, EW)
    pair = [normal(3), normal(3, seed=1)]
    mats = [normal(2, 3), normal(2, 3, seed=1)]
    c["column_stack"] = ("column_stack", [pair], {}, EW)
    c["hstack"] = ("hstack", [mats], {}, EW)
    c["vstack"] = ("vstack", [pair], {}, EW)
    c["dstack"] = ("dstack", [mats], {}, EW)
    c["row_stack"] = ("row_stack", [mats], {}, EW)
    c["atleast_1d"] = ("atleast_1d", [np.array(2.5, np.float32)], {}, EW)
    c["atleast_2d"] = ("atleast_2d", [normal(3)], {}, EW)
    c["atleast_3d"] = ("atleast_3d", [normal(2, 3)], {}, EW)
    c["atleast_3d_1d"] = ("atleast_3d", [normal(3)], {}, EW)
    c["diag_embed"] = ("diag_embed", [normal(2, 3)], dict(offset=1), EW)
    c["diag_embed_dims"] = ("diag_embed", [normal(2, 3)], dict(
        offset=-1, dim1=0, dim2=2), EW)
    c["gather_tree"] = ("gather_tree", [ints(0, 9, 5, 2, 3),
                                        ints(0, 3, 5, 2, 3, seed=1)], {}, EW)
    # the round-2 math tranche
    c["stanh"] = ("stanh", [X34], dict(scale_a=0.5, scale_b=2.0), EW)
    c["tanh_shrink"] = ("tanh_shrink", [X34], {}, EW)
    c["logspace"] = ("logspace", [], dict(start=0.0, stop=2.0, num=5), EW)
    c["logspace_base2"] = ("logspace", [], dict(start=-1, stop=3, num=4,
                                                base=2.0), EW)
    c["complex"] = ("complex", [X34, normal(3, 4, seed=1)], {}, EW)
    c["dist"] = ("dist", [X34, normal(3, 4, seed=1)], dict(p=3.0), NORM)
    c["dist_inf"] = ("dist", [X34, normal(3, 4, seed=1)],
                     dict(p=float("inf")), NORM)
    c["p_norm"] = ("p_norm", [X34], dict(porder=3.0, axis=1), NORM)
    c["p_norm_vector"] = ("p_norm", [X34], dict(asvector=True,
                                                keepdim=True), NORM)
    c["frobenius_norm"] = ("frobenius_norm", [normal(2, 3, 4)],
                           dict(axis=[1, 2]), NORM)
    c["frobenius_norm_all"] = ("frobenius_norm", [X34], {}, NORM)
    c["squared_l2_norm"] = ("squared_l2_norm", [X34], {}, NORM)
    c["clip_by_norm"] = ("clip_by_norm", [X34], dict(max_norm=1.0), NORM)
    c["add_n"] = ("add_n", [[X34, normal(3, 4, seed=1),
                             normal(3, 4, seed=2)]], {}, EW)
    c["mean_all"] = ("mean_all", [X34], {}, EW)
    onehot = np.eye(4, dtype=np.float32)[[0, 2, 1]]
    c["label_smooth"] = ("label_smooth", [onehot], dict(epsilon=0.2), EW)
    c["label_smooth_prior"] = ("label_smooth", [
        onehot, np.array([0.1, 0.2, 0.3, 0.4], np.float32)], {}, EW)
    c["huber_loss"] = ("huber_loss", [X34, normal(3, 4, seed=1)],
                       dict(delta=0.5), EW)
    c["bce_loss"] = ("bce_loss", [uniform(0.05, 0.95, 3, 4),
                                  uniform(0, 1, 3, 4, seed=1)], {}, EW)
    c["kldiv_loss"] = ("kldiv_loss", [X34, uniform(0.1, 1, 3, 4, seed=1)],
                       {}, EW)
    for red in ("batchmean", "sum", "none"):
        c[f"kldiv_loss_{red}"] = ("kldiv_loss", [
            X34, uniform(0.1, 1, 3, 4, seed=1)], dict(reduction=red), EW)
    c["kldiv_loss_log_target"] = ("kldiv_loss", [X34, normal(3, 4, seed=1)],
                                  dict(log_target=True), EW)
    c["log_loss"] = ("log_loss", [uniform(0.05, 0.95, 3, 1),
                                  uniform(0, 1, 3, 1, seed=1)], {}, EW)
    lbl = (uniform(0, 1, 3, 4, seed=1) > 0.5).astype(np.float32)
    lbl[0, 0] = -100
    c["sigmoid_cross_entropy_with_logits"] = (
        "sigmoid_cross_entropy_with_logits", [X34, lbl], {}, EW)
    c["sigmoid_ce_pos_weight"] = (
        "sigmoid_cross_entropy_with_logits",
        [X34, lbl, uniform(0.5, 2, 3, 4, seed=2)], dict(normalize=True), EW)
    c["accuracy"] = ("accuracy", [normal(6, 5), ints(0, 5, 6, 1)],
                     dict(k=2), EW)
    c["is_empty"] = ("is_empty", [X34], {}, EW)
    c["is_empty_true"] = ("is_empty", [np.zeros((0, 3), np.float32)], {}, EW)
    c["assign_value"] = ("assign_value", [], dict(
        shape=[2, 3], dtype="float32", values=[1, 2, 3, 4, 5, 6]), EW)
    c["unique_consecutive"] = ("unique_consecutive", [np.array(
        [1, 1, 2, 2, 3, 1, 1, 2], np.int32)], dict(
        return_inverse=True, return_counts=True), EW)
    c["unique_consecutive_axis"] = ("unique_consecutive", [np.array(
        [[1, 1, 2], [1, 1, 2], [3, 0, 1]], np.float32)], dict(
        axis=0, return_counts=True), EW)
    c["repeat_interleave_with_tensor_index"] = (
        "repeat_interleave_with_tensor_index",
        [X34, np.array([1, 0, 2], np.int32)], {}, EW)
    c["shard_index"] = ("shard_index", [ints(0, 20, 6, 1)], dict(
        index_num=20, nshards=2, shard_id=1), EW)
    c["edit_distance"] = ("edit_distance", [
        ints(0, 4, 3, 5), ints(0, 4, 3, 6, seed=1),
        np.array([5, 3, 0], np.int64), np.array([6, 4, 2], np.int64)], {},
        EW)
    c["edit_distance_raw"] = ("edit_distance", [
        ints(0, 4, 2, 5), ints(0, 4, 2, 5, seed=1)],
        dict(normalized=False), EW)
    c["view_dtype"] = ("view_dtype", [X34], dict(dtype="int32"), EW)
    c["view_dtype_narrow"] = ("view_dtype", [X34], dict(dtype="int16"), EW)
    c["view_dtype_wide"] = ("view_dtype", [ints(0, 9, 3, 2).astype(
        np.int16)], dict(dtype="float32"), EW)
    c["set_value"] = ("set_value", [normal(4, 5), normal(2, 2, seed=1)],
                      dict(starts=[0, 1], ends=[4, 5], steps=[2, 2],
                           axes=[0, 1]), EW)
    c["set_value_scalar"] = ("set_value", [normal(4, 5)], dict(
        starts=[1], ends=[3], steps=[1], axes=[0]), EW)
    c["einsum"] = ("einsum", [[normal(2, 3), normal(3, 4, seed=1)]],
                   dict(equation="ij,jk->ik"), EW)
    c["einsum_trace"] = ("einsum", [[normal(3, 3)]], dict(equation="ii->"),
                         EW)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry(case):
    name, args, kw, tol = CASES[case]
    check_op(name, args, kw, **tol)


def test_fill_inplace_writes_its_input():
    x = torch.from_numpy(normal(3, 4))
    out = tdisp.call_op("fill_", x, 2.5)
    assert out is x and bool((x == 2.5).all())
    r = RTensor(normal(3, 4))
    rdisp.call_op("fill_", r, 2.5)
    np.testing.assert_array_equal(x.numpy(), r.numpy())


def test_every_entry_has_a_case():
    from paddle_tpu_torch.ops.kernels import extra_math, math_ext
    mine = {n for n, k in tdisp.KERNELS.items()
            if k.__module__ in (extra_math.__name__,)}
    tranche = {"nanquantile", "vander", "trapezoid", "polar", "cdist",
               "crop", "block_diag", "broadcast_tensors", "column_stack",
               "hstack", "vstack", "dstack", "row_stack", "atleast_1d",
               "atleast_2d", "atleast_3d", "diag_embed", "gather_tree"}
    assert tranche <= {n for n, k in tdisp.KERNELS.items()
                       if k.__module__ == math_ext.__name__}
    covered = {v[0] for v in CASES.values()} | {"fill_"}
    assert (mine | tranche) - covered == set()
