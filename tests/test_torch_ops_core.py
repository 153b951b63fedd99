"""The port's core op table (``ops/kernels/creation.py``, ``math.py``,
``manipulation.py`` and the new entries of ``nn.py``) against the JAX
package's ops, on the CPU, through ``tests/_torch_op_check.py``: one case
or more per op, each the same seeded numpy inputs through both
registries' ``call_op``, forward, and for an op the reference
differentiates, the VJP of its floating inputs under a random cotangent.

Tolerances (float32): atol 1e-6 for elementwise ops (1e-5 for lgamma and
digamma, whose values near their roots cancel), 1e-5 for reductions
and products, 1e-4 for decompositions, each with rtol 1e-6 (1e-5 for
reductions and products, 1e-4 for decompositions) for values far from 1.
Integer outputs are compared by value (the port's are int64 where the
reference's are int32).

Also: ``matmul``'s ``transpose_x`` / ``transpose_y`` over 1-D to 4-D
operands; ``round`` halving to even; the sign rules of ``remainder``,
``mod``, ``fmod`` and ``floor_divide`` over ints; ``median`` of an even
count; ``sort`` / ``argsort`` stable on ties; ``getitem``'s index forms;
``gumbel_softmax`` from the port's generator (the noise fed to both
packages, then the distribution's rows and its straight-through grads);
the pools' ``ceil_mode`` held to the reference's ``pool2d`` op; and the
data-dependent ops raising under capture.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp
from paddle_tpu_torch.ops.kernels import fused_optimizer as fok
from paddle_tpu_torch.ops.kernels import manipulation as tman
from paddle_tpu_torch.ops.kernels import nn as tnn_ops

from _torch_op_check import check_fn, check_op

EW = dict(atol=1e-6, rtol=1e-6)      # elementwise
RED = dict(atol=1e-5, rtol=1e-5)     # reductions and products
DEC = dict(atol=1e-4, rtol=1e-4)     # decompositions
SPECIAL = dict(atol=1e-5, rtol=1e-5)  # lgamma, digamma: near their roots


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _r(seed=0):
    return np.random.RandomState(seed)


def normal(*shape, seed=0, scale=1.0):
    return (_r(seed).randn(*shape) * scale).astype(np.float32)


def uniform(lo, hi, *shape, seed=0):
    return _r(seed).uniform(lo, hi, shape).astype(np.float32)


def ints(lo, hi, *shape, seed=0):
    return _r(seed).randint(lo, hi, shape).astype(np.int32)


def bools(*shape, seed=0):
    return _r(seed).rand(*shape) > 0.5


X34 = normal(3, 4)
DOMAIN = {
    "log": uniform(0.1, 3, 3, 4), "log2": uniform(0.1, 3, 3, 4),
    "log10": uniform(0.1, 3, 3, 4), "sqrt": uniform(0.1, 3, 3, 4),
    "rsqrt": uniform(0.1, 3, 3, 4), "lgamma": uniform(0.2, 4, 3, 4),
    "digamma": uniform(0.5, 4, 3, 4), "reciprocal": uniform(0.5, 3, 3, 4),
    "asin": uniform(-0.9, 0.9, 3, 4), "acos": uniform(-0.9, 0.9, 3, 4),
    "atanh": uniform(-0.9, 0.9, 3, 4), "erfinv": uniform(-0.9, 0.9, 3, 4),
    "acosh": uniform(1.1, 3, 3, 4), "log1p": uniform(-0.5, 2, 3, 4),
    "tan": uniform(-1, 1, 3, 4),
}
FLOAT_UNARY = ["abs", "exp", "log", "log2", "log10", "log1p", "expm1",
               "sqrt", "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan",
               "sinh", "cosh", "asinh", "acosh", "atanh", "floor", "ceil",
               "trunc", "sign", "square", "reciprocal", "neg", "erf",
               "erfinv", "lgamma", "digamma", "frac", "conj", "angle",
               "real", "imag", "t", "matrix_transpose", "tanhshrink",
               "assign"]
FLOAT_BINARY = ["add", "subtract", "multiply", "divide", "pow", "maximum",
                "minimum", "remainder", "mod", "fmod", "atan2", "logaddexp",
                "hypot"]
COMPARE = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal"]
LOGICAL = ["logical_and", "logical_or", "logical_xor"]
BITWISE = ["bitwise_and", "bitwise_or", "bitwise_xor"]
REDUCE = ["sum", "mean", "max", "min", "prod", "logsumexp", "amax", "amin",
          "std", "var", "median", "nanmean", "nansum"]
REDUCE_AXES = {"all": {}, "axis1": dict(axis=1),
               "axes02_keep": dict(axis=[0, 2], keepdim=True)}


def _binary_y(name):
    if name in ("divide", "remainder", "mod", "fmod"):
        y = uniform(0.5, 2, 4, seed=1) * np.where(ints(0, 2, 4, seed=2),
                                                   1, -1).astype(np.float32)
        return y
    return normal(4, seed=1)


def _cases():
    c = {}
    for n in FLOAT_UNARY:
        c[n] = (n, [DOMAIN.get(n, X34)], {},
                SPECIAL if n in ("lgamma", "digamma") else EW)
    c["round"] = ("round", [np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49,
                                      2.51], np.float32)], {}, EW)
    c["round_random"] = ("round", [X34 * 3], {}, EW)
    special = np.array([0.0, 1.0, np.inf, -np.inf, np.nan, -2.0], np.float32)
    for n in ("isnan", "isinf", "isfinite"):
        c[n] = (n, [special], {}, EW)
    c["logical_not"] = ("logical_not", [bools(3, 4)], {}, EW)
    c["bitwise_not"] = ("bitwise_not", [ints(-50, 50, 3, 4)], {}, EW)
    for n in FLOAT_BINARY:
        x = uniform(0.5, 2, 3, 4) if n == "pow" else X34
        c[n] = (n, [x, _binary_y(n)], {}, EW)
    for n in ("remainder", "mod", "fmod", "floor_divide"):
        xi = np.array([7, -7, 7, -7, 5, -5, 0, 9], np.int32)
        yi = np.array([3, 3, -3, -3, 5, 2, 4, -4], np.int32)
        c[n + "_int_signs"] = (n, [xi, yi], {}, EW)
    c["floor_divide"] = ("floor_divide", [X34, _binary_y("divide")], {}, EW)
    for n in ("gcd", "lcm"):
        c[n] = (n, [ints(-30, 30, 3, 4), ints(1, 30, 3, 4, seed=1)], {}, EW)
    xt = np.round(X34 * 2) / 2
    for n in COMPARE:
        c[n] = (n, [xt, np.round(normal(4, seed=1) * 2) / 2], {}, EW)
    for n in LOGICAL:
        c[n] = (n, [bools(3, 4), bools(3, 4, seed=1)], {}, EW)
    for n in BITWISE:
        c[n] = (n, [ints(-50, 50, 3, 4), ints(-50, 50, 3, 4, seed=1)], {},
                EW)
    c["equal_all_same"] = ("equal_all", [X34, X34.copy()], {}, EW)
    c["equal_all_diff"] = ("equal_all", [X34, X34 + 1e-3], {}, EW)
    y_close = X34 + np.float32(1e-6) * normal(3, 4, seed=3)
    for n in ("allclose", "isclose"):
        c[n] = (n, [X34, y_close], {}, EW)
        c[n + "_rtol"] = (n, [X34, X34 * 1.01], dict(rtol=0.02, atol=0.0),
                          EW)
    c["scale"] = ("scale", [X34], dict(scale=2.5, bias=-1.0), EW)
    c["scale_before"] = ("scale", [X34], dict(scale=2.5, bias=-1.0,
                                              bias_after_scale=False), EW)
    c["clip"] = ("clip", [X34], dict(min=-0.5, max=0.7), EW)
    c["clip_min_only"] = ("clip", [X34], dict(min=-0.2), EW)
    c["lerp"] = ("lerp", [X34, normal(3, 4, seed=1),
                          uniform(0, 1, 3, 4, seed=2)], {}, EW)
    c["addmm"] = ("addmm", [normal(3, 5), X34, normal(4, 5, seed=1)],
                  dict(beta=0.5, alpha=2.0), RED)
    # reductions
    x345 = normal(3, 4, 5, seed=4)
    for n in REDUCE:
        for tag, kw in REDUCE_AXES.items():
            c[f"{n}_{tag}"] = (n, [x345], kw, RED)
    c["median_even"] = ("median", [normal(3, 6, seed=5)], dict(axis=1), RED)
    c["sum_bool"] = ("sum", [bools(3, 4)], {}, RED)
    c["sum_dtype"] = ("sum", [ints(0, 9, 3, 4)], dict(axis=0,
                                                      dtype="float32"), RED)
    c["mean_int"] = ("mean", [ints(0, 9, 3, 4)], {}, RED)
    c["prod_dtype"] = ("prod", [uniform(0.5, 1.5, 3, 4)],
                       dict(axis=1, keepdim=True), RED)
    nan_x = x345.copy()
    nan_x[0, 1, 2] = nan_x[2, 3, 0] = np.nan
    c["nanmean_nan"] = ("nanmean", [nan_x], dict(axis=1), RED)
    c["nansum_nan"] = ("nansum", [nan_x], dict(axis=2), RED)
    for n in ("any", "all"):
        for tag, kw in REDUCE_AXES.items():
            c[f"{n}_{tag}"] = (n, [bools(3, 4, 5)], kw, RED)
    c["cumsum"] = ("cumsum", [x345], dict(axis=1), RED)
    c["cumsum_flat"] = ("cumsum", [x345], {}, RED)
    c["cumprod"] = ("cumprod", [uniform(0.5, 1.5, 3, 4)], dict(dim=1), RED)
    c["cumprod_flat"] = ("cumprod", [uniform(0.8, 1.2, 3, 4)], {}, RED)
    c["cummax"] = ("cummax", [x345], dict(axis=2), RED)
    c["cummin"] = ("cummin", [x345], dict(axis=0), RED)
    # linalg
    c["dot"] = ("dot", [X34, normal(3, 4, seed=1)], {}, RED)
    c["outer"] = ("outer", [normal(4), normal(5, seed=1)], {}, RED)
    c["cross"] = ("cross", [normal(4, 3), normal(4, 3, seed=1)], {}, RED)
    c["cross_axis0"] = ("cross", [normal(3, 4), normal(3, 4, seed=1)],
                        dict(axis=0), RED)
    c["bmm"] = ("bmm", [normal(2, 3, 4), normal(2, 4, 5, seed=1)], {}, RED)
    c["mv"] = ("mv", [X34, normal(4, seed=1)], {}, RED)
    c["t_1d"] = ("t", [normal(5)], {}, EW)
    c["matrix_transpose_3d"] = ("matrix_transpose", [x345], {}, EW)
    c["norm_flat"] = ("norm", [x345], {}, RED)
    c["norm_p1_axis"] = ("norm", [x345], dict(p=1.0, axis=1), RED)
    c["norm_inf"] = ("norm", [x345], dict(p=float("inf"), axis=2), RED)
    c["norm_neg_inf"] = ("norm", [x345], dict(p=float("-inf")), RED)
    c["norm_fro"] = ("norm", [x345], dict(p="fro", axis=[1, 2],
                                          keepdim=True), RED)
    c["norm_matrix_2"] = ("norm", [x345], dict(p=2.0, axis=[1, 2]), DEC)
    c["einsum_impl"] = ("einsum_impl", [[normal(2, 3, 4),
                                         normal(2, 4, 5, seed=1)]],
                        dict(equation="bij,bjk->bik"), RED)
    c["einsum_trace"] = ("einsum_impl", [[normal(4, 4)]],
                         dict(equation="ii->"), RED)
    tri = np.triu(normal(4, 4, seed=6)) + 3 * np.eye(4, dtype=np.float32)
    rhs = normal(4, 2, seed=7)
    c["triangular_solve_upper"] = ("triangular_solve", [tri, rhs], {}, DEC)
    c["triangular_solve_lower_t"] = ("triangular_solve", [tri.T.copy(), rhs],
                                     dict(upper=False, transpose=True), DEC)
    c["triangular_solve_unit"] = ("triangular_solve", [tri, rhs],
                                  dict(unitriangular=True), DEC)
    a = normal(4, 4, seed=8)
    spd = (a @ a.T + 4 * np.eye(4)).astype(np.float32)
    c["cholesky"] = ("cholesky", [spd], {}, DEC)
    c["cholesky_upper"] = ("cholesky", [spd], dict(upper=True), DEC)
    c["inverse"] = ("inverse", [spd], {}, DEC)
    c["trace"] = ("trace", [normal(4, 5)], dict(offset=1), RED)
    c["trace_axes"] = ("trace", [x345], dict(axis1=1, axis2=2), RED)
    c["kron"] = ("kron", [normal(2, 3), normal(3, 2, seed=1)], {}, RED)
    c["diagonal"] = ("diagonal", [x345], dict(offset=-1, axis1=1, axis2=2),
                     EW)
    # manipulation
    c["reshape"] = ("reshape", [x345], dict(shape=[4, -1]), EW)
    c["transpose"] = ("transpose", [x345], dict(perm=[2, 0, 1]), EW)
    c["swapaxes"] = ("swapaxes", [x345], dict(axis1=0, axis2=2), EW)
    c["moveaxis"] = ("moveaxis", [x345], dict(source=[0, 1],
                                              destination=[2, 0]), EW)
    c["concat"] = ("concat", [[X34, normal(2, 4, seed=1)]], {}, EW)
    c["concat_axis1"] = ("concat", [[X34, normal(3, 2, seed=1)]],
                         dict(axis=1), EW)
    c["stack"] = ("stack", [[X34, normal(3, 4, seed=1)]], dict(axis=1), EW)
    c["split_equal"] = ("split", [normal(6, 4)], dict(num_or_sections=3),
                        EW)
    c["split_sections"] = ("split", [normal(3, 7)],
                           dict(num_or_sections=[2, -1, 3], axis=1), EW)
    c["chunk_uneven"] = ("chunk", [normal(7, 3)], dict(chunks=3), EW)
    c["unstack"] = ("unstack", [x345], dict(axis=1), EW)
    c["unbind"] = ("unbind", [x345], {}, EW)
    c["squeeze_all"] = ("squeeze", [normal(3, 1, 4, 1)], {}, EW)
    c["squeeze_axes"] = ("squeeze", [normal(3, 1, 4, 1)],
                         dict(axis=[1, 2]), EW)
    c["unsqueeze"] = ("unsqueeze", [X34], dict(axis=[0, -1]), EW)
    c["flatten"] = ("flatten", [x345], dict(start_axis=1), EW)
    c["expand"] = ("expand", [normal(3, 1)], dict(shape=[2, -1, 4]), EW)
    c["broadcast_to"] = ("broadcast_to", [normal(1, 4)],
                         dict(shape=[3, 4]), EW)
    c["tile"] = ("tile", [X34], dict(repeat_times=[2, 1, 2]), EW)
    c["repeat_interleave"] = ("repeat_interleave", [X34],
                              dict(repeats=2, axis=1), EW)
    c["repeat_interleave_flat"] = ("repeat_interleave", [X34],
                                   dict(repeats=3), EW)
    c["flip"] = ("flip", [x345], dict(axis=[0, 2]), EW)
    c["roll"] = ("roll", [x345], dict(shifts=2, axis=1), EW)
    c["roll_flat"] = ("roll", [X34], dict(shifts=-3), EW)
    c["cast"] = ("cast", [X34 * 5], dict(dtype="int32"), EW)
    c["cast_bool"] = ("cast", [ints(0, 3, 3, 4)], dict(dtype="bool"), EW)
    c["slice"] = ("slice", [x345], dict(axes=[0, 2], starts=[1, -3],
                                        ends=[3, 5]), EW)
    c["strided_slice"] = ("strided_slice", [x345],
                          dict(axes=[1, 2], starts=[0, 4], ends=[4, 0],
                               strides=[2, -2]), EW)
    c["gather"] = ("gather", [x345, np.array([2, 0, 2], np.int32)],
                   dict(axis=1), EW)
    c["gather_2d_index"] = ("gather", [X34, ints(0, 3, 2, 2)], {}, EW)
    c["gather_nd"] = ("gather_nd", [x345, np.array([[0, 1], [2, 3]],
                                                    np.int32)], {}, EW)
    c["take_along_axis"] = ("take_along_axis", [X34, ints(0, 4, 3, 2)],
                            dict(axis=1), EW)
    c["put_along_axis"] = ("put_along_axis",
                           [X34, np.array([[0], [2], [1]], np.int32),
                            normal(3, 1, seed=1)], dict(axis=1), EW)
    c["put_along_axis_add"] = ("put_along_axis",
                               [X34, np.array([[0, 3], [2, 1], [1, 0]],
                                              np.int32),
                                normal(3, 2, seed=1)],
                               dict(axis=1, reduce="add"), EW)
    c["put_along_axis_mul"] = ("put_along_axis",
                               [X34, np.array([[0], [2], [1]], np.int32),
                                normal(3, 1, seed=1)],
                               dict(axis=1, reduce="multiply"),
                               dict(EW, grad=False))  # no reference VJP
    c["scatter"] = ("scatter", [normal(5, 3), np.array([3, 0], np.int32),
                                normal(2, 3, seed=1)], {}, EW)
    c["scatter_add"] = ("scatter", [normal(5, 3),
                                    np.array([[3], [0], [3]], np.int32),
                                    normal(3, 3, seed=1)],
                        dict(overwrite=False), EW)
    c["scatter_nd_add"] = ("scatter_nd_add",
                           [normal(4, 3), np.array([[1], [3], [1]],
                                                   np.int32),
                            normal(3, 3, seed=1)], {}, EW)
    c["index_select"] = ("index_select", [x345, np.array([4, 1], np.int32)],
                         dict(axis=2), EW)
    c["where"] = ("where", [bools(3, 4), X34, normal(3, 4, seed=1)], {}, EW)
    c["where_broadcast"] = ("where", [bools(3, 1), X34, normal(4, seed=1)],
                            {}, EW)
    c["masked_fill"] = ("masked_fill", [X34, bools(3, 4)], dict(value=-2.5),
                        EW)
    c["tril"] = ("tril", [normal(4, 5)], dict(diagonal=1), EW)
    c["triu"] = ("triu", [normal(4, 5)], dict(diagonal=-1), EW)
    c["numel"] = ("numel", [x345], {}, EW)
    c["shape_op"] = ("shape_op", [x345], {}, EW)
    z = (normal(3, 4) + 1j * normal(3, 4, seed=1)).astype(np.complex64)
    c["as_real"] = ("as_real", [z], {}, EW)
    c["as_complex"] = ("as_complex", [normal(3, 4, 2)], {}, EW)
    for n in ("conj", "angle", "real", "imag"):
        c[n + "_complex"] = (n, [z], {}, EW)
    # search / sort
    ties = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 5, 0, 1]], np.float32)
    c["argmax"] = ("argmax", [x345], dict(axis=1), EW)
    c["argmax_flat"] = ("argmax", [x345], {}, EW)
    c["argmin_keep"] = ("argmin", [x345], dict(axis=2, keepdim=True), EW)
    c["argsort_ties"] = ("argsort", [ties], {}, EW)
    c["argsort_desc_ties"] = ("argsort", [ties], dict(descending=True), EW)
    c["sort"] = ("sort", [x345], dict(axis=1), EW)
    c["sort_desc"] = ("sort", [x345], dict(descending=True), EW)
    c["topk"] = ("topk", [x345], dict(k=2), EW)
    c["topk_smallest_axis1"] = ("topk", [x345], dict(k=3, axis=1,
                                                     largest=False), EW)
    seq = np.sort(normal(8, seed=9))
    c["searchsorted"] = ("searchsorted", [seq, normal(3, 4, seed=10)], {},
                         EW)
    c["searchsorted_right"] = ("searchsorted", [np.array(
        [0, 1, 1, 2, 3], np.float32), np.array([1.0, 0.5, 3.0, 2.0],
                                               np.float32)],
        dict(right=True), EW)
    c["bincount"] = ("bincount", [ints(0, 6, 20)], dict(minlength=8), EW)
    c["bincount_weights"] = ("bincount", [ints(0, 6, 20),
                                          uniform(0, 1, 20, seed=1)], {},
                             RED)
    c["histogram"] = ("histogram", [uniform(-1, 1, 50)],
                      dict(bins=7, min=-1.0, max=1.0), EW)
    c["histogram_range"] = ("histogram", [normal(40)], dict(bins=5), EW)
    c["nonzero"] = ("nonzero", [ints(0, 2, 3, 4).astype(np.float32)], {},
                    EW)
    c["masked_select"] = ("masked_select", [X34, bools(3, 4)], {}, EW)
    dup = ints(0, 5, 12, seed=11)
    c["unique"] = ("unique", [dup], {}, EW)
    c["unique_all"] = ("unique", [dup], dict(return_index=True,
                                             return_inverse=True,
                                             return_counts=True), EW)
    c["unique_axis"] = ("unique", [np.array([[1, 2], [0, 1], [1, 2]],
                                            np.int32)],
                        dict(axis=0, return_counts=True), EW)
    # activations, nn core, losses
    c["celu"] = ("celu", [X34], dict(alpha=0.7), EW)
    c["hardtanh"] = ("hardtanh", [X34], dict(min=-0.5, max=0.8), EW)
    c["softshrink"] = ("softshrink", [X34], dict(threshold=0.3), EW)
    c["hardshrink"] = ("hardshrink", [X34], dict(threshold=0.3), EW)
    c["thresholded_relu"] = ("thresholded_relu", [X34],
                             dict(threshold=0.2), EW)
    c["glu"] = ("glu", [normal(3, 6)], {}, EW)
    c["glu_axis0"] = ("glu", [normal(4, 3)], dict(axis=0), EW)
    c["unfold"] = ("unfold", [normal(2, 3, 6, 5)],
                   dict(kernel_sizes=[3, 2], strides=2, paddings=1), EW)
    labels = ints(0, 5, 4)
    labels[1] = -100
    c["softmax_with_cross_entropy"] = ("softmax_with_cross_entropy",
                                       [normal(4, 5), labels[:, None]], {},
                                       RED)
    soft = np.abs(normal(4, 5, seed=1))
    soft /= soft.sum(-1, keepdims=True)
    c["softmax_with_cross_entropy_soft"] = (
        "softmax_with_cross_entropy", [normal(4, 5), soft],
        dict(soft_label=True), RED)
    c["cosine_similarity"] = ("cosine_similarity",
                              [normal(4, 6), normal(4, 6, seed=1)], {}, RED)
    c["cosine_similarity_axis"] = ("cosine_similarity",
                                   [x345, normal(3, 4, 5, seed=1)],
                                   dict(axis=-1), RED)
    hl = np.where(bools(3, 4), 1.0, -1.0).astype(np.float32)
    for red in ("mean", "sum", "none"):
        c["hinge_embedding_loss_" + red] = (
            "hinge_embedding_loss", [X34, hl], dict(reduction=red), RED)
    # creation
    c["full"] = ("full", [], dict(shape=[2, 3], fill_value=1.5), EW)
    c["full_int"] = ("full", [], dict(shape=[4], fill_value=7), EW)
    c["full_like"] = ("full_like", [X34], dict(fill_value=-2.0), EW)
    for n in ("zeros", "ones", "empty"):
        c[n] = (n, [], dict(shape=[2, 3]), EW)
        c[n + "_int"] = (n, [], dict(shape=[3], dtype="int32"), EW)
    for n in ("zeros_like", "ones_like", "empty_like"):
        c[n] = (n, [X34], {}, EW)
    c["arange"] = ("arange", [], dict(start=7), EW)
    c["arange_step"] = ("arange", [], dict(start=2, end=11, step=3), EW)
    c["arange_float"] = ("arange", [], dict(start=0.5, end=2.0, step=0.25),
                         EW)
    c["linspace"] = ("linspace", [], dict(start=-1.0, stop=2.0, num=7), EW)
    c["eye"] = ("eye", [], dict(num_rows=3, num_columns=5), EW)
    c["tril_indices"] = ("tril_indices", [], dict(rows=4, cols=5, offset=1),
                         EW)
    c["diag_vector"] = ("diag", [normal(4)], dict(offset=1), EW)
    c["diag_matrix"] = ("diag", [normal(4, 5)], dict(offset=-1), EW)
    c["diagflat"] = ("diagflat", [normal(2, 2)], dict(offset=1), EW)
    c["meshgrid"] = ("meshgrid", [[normal(3), normal(4, seed=1)]], {}, EW)
    for tag, idx in (("int", 1), ("slice", (slice(None), slice(1, 3)))):
        c["getitem_" + tag] = ("getitem", [x345], dict(index=idx), EW)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name, args, kw, tol = CASES[case]
    check_op(name, args, kw, **tol)


def test_every_new_op_has_a_case():
    """Each op of the port's table that this test file owns (every op but
    those the older test files hold: the layer ops, attention, serving,
    GEMMs, the recurrences) has at least one case."""
    covered = {v[0] for v in CASES.values()} | {
        "gumbel_softmax", "matmul", "index_add", "getitem"}
    from paddle_tpu_torch.ops.kernels import creation, manipulation, math
    owned = {n for n, k in tdisp.KERNELS.items()
             if k.__module__ in (creation.__name__, manipulation.__name__,
                                 math.__name__)}
    owned |= {"celu", "hardtanh", "tanhshrink", "softshrink", "hardshrink",
              "thresholded_relu", "glu", "unfold", "cosine_similarity",
              "softmax_with_cross_entropy", "hinge_embedding_loss"}
    assert owned - covered == set()


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("shapes", [((4,), (4,)), ((3, 4), (4,)),
                                    ((4,), (4, 5)), ((3, 4), (4, 5)),
                                    ((2, 3, 4), (4, 5)),
                                    ((2, 1, 3, 4), (3, 4, 5))],
                         ids=["1dx1d", "2dx1d", "1dx2d", "2dx2d", "3dx2d",
                              "4dx3d"])
def test_matmul_transposes_match_reference(shapes, tx, ty):
    sx, sy = shapes
    x = normal(*sx)
    y = normal(*sy, seed=1)
    if tx and x.ndim > 1:
        x = np.swapaxes(x, -1, -2).copy()
    if ty and y.ndim > 1:
        y = np.swapaxes(y, -1, -2).copy()
    check_op("matmul", [x, y], dict(transpose_x=tx, transpose_y=ty), **RED)


GETITEM = {"none_ellipsis": (None, Ellipsis, 2),
           "bool": bools(3, seed=5),
           "int_array": np.array([2, 0, 2], np.int32),
           "mixed": (np.array([0, 2], np.int32), slice(None),
                     np.array([1, 4], np.int32)),
           "negative_step": (slice(None, None, -1), 1)}


@pytest.mark.parametrize("case", sorted(GETITEM))
def test_getitem_index_forms_match_reference_kernel(case):
    """Index forms the reference's ``call_op`` turns into attributes
    (arrays, tuples with None / Ellipsis), held to its kernel
    (``manipulation.getitem``) over jax arrays, with its VJP."""
    from paddle_tpu.ops.kernels import manipulation as rman
    idx = GETITEM[case]
    jidx = tuple(jax.numpy.asarray(i) if isinstance(i, np.ndarray) else i
                 for i in idx) if isinstance(idx, tuple) \
        else jax.numpy.asarray(idx)
    check_fn("getitem", [normal(3, 4, 5)], dict(index=idx),
             lambda x, index: rman.getitem(x, jidx), **EW)


def test_index_add_matches_reference_kernel():
    """The reference's ``call_op("index_add")`` passes ``value``
    positionally into ``axis``; held to its kernel instead."""
    from paddle_tpu.ops.kernels import manipulation as rman
    idx = np.array([0, 2, 0], np.int32)
    check_fn("index_add", [X34, idx, 1, normal(3, 3, seed=1)], {},
             lambda x, i, a, v: rman.index_add(x, i, a, v), **EW)


def test_tied_logits_matmul_gives_the_same_bits_as_torch_matmul():
    """The Llama path's tied-logits call (``nn.matmul(h, E.T)``) is the
    registry's ``matmul`` now: the same bits as ``torch.matmul``."""
    h, e = torch.randn(2, 5, 16), torch.randn(32, 16)
    assert torch.equal(tnn_ops.matmul(h, e.T), torch.matmul(h, e.T))
    assert torch.equal(tnn_ops.mean(h), h.mean())


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_gumbel_softmax_matches_reference_on_the_same_noise(monkeypatch,
                                                            hard):
    """The noise fed to both packages (the reference draws it with
    ``jax.random.gumbel``, the port with ``nn.gumbel_noise`` from its
    generator): values, and the straight-through grads for ``hard``."""
    x = normal(4, 6)
    g = normal(4, 6, seed=3)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=None: jax.numpy.asarray(g))
    monkeypatch.setattr(tnn_ops, "gumbel_noise",
                        lambda shape, dtype, gen: torch.from_numpy(g))
    check_op("gumbel_softmax", [x], dict(temperature=0.7, hard=hard), **EW)


def test_gumbel_softmax_draws_from_the_port_generator():
    from paddle_tpu_torch.nn.initializer import seed
    x = torch.from_numpy(normal(8, 5))
    state = torch.random.get_rng_state()
    seed(3)
    a = tdisp.call_op("gumbel_softmax", x)
    b = tdisp.call_op("gumbel_softmax", x)
    seed(3)
    a2 = tdisp.call_op("gumbel_softmax", x)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    torch.testing.assert_close(a.sum(-1), torch.ones(8))
    h = tdisp.call_op("gumbel_softmax", x, hard=True)
    torch.testing.assert_close(h.sum(-1), torch.ones(8))
    assert torch.equal(h.argmax(-1), (h > 0.5).long().argmax(-1))
    assert int((h > 0.5).sum()) == 8


POOL_C5 = [(op, pad, excl) for op in ("max", "avg") for pad in (0, 1)
           for excl in ((True, False) if op == "avg" else (True,))]


@pytest.mark.parametrize("op,pad,exclusive", POOL_C5,
                         ids=[f"{o}_p{p}" + ("" if o == "max" else
                                             "_excl" if e else "_incl")
                              for o, p, e in POOL_C5])
def test_pool_ceil_mode_matches_reference_pool2d(op, pad, exclusive):
    """``ceil_mode`` keeps the last partial window (the reference's
    ``max_pool2d`` / ``avg_pool2d`` ops ignore it; its ``pool2d`` op
    honours it, and non-exclusive averaging divides by the whole k·k)."""
    x = normal(2, 3, 8, 8)
    kw = dict(kernel_size=3, stride=2, padding=pad, ceil_mode=True)
    if op == "avg":
        kw["exclusive"] = exclusive
    ref_kw = dict(kernel_size=(3, 3), strides=(2, 2), paddings=(pad, pad),
                  pooling_type=op, ceil_mode=True, exclusive=exclusive)
    out = check_op(f"{op}_pool2d", [x], kw, **EW,
                   ref=("pool2d", [x], ref_kw))
    side = -(-(8 + 2 * pad - 3) // 2) + 1          # the ceil-mode size
    assert tuple(out.shape) == (2, 3, side, side)


@pytest.mark.parametrize("name,args", [
    ("nonzero", [torch.ones(3)]),
    ("masked_select", [torch.ones(3), torch.ones(3, dtype=torch.bool)]),
    ("unique", [torch.ones(3)]), ("histogram", [torch.ones(3)]),
    ("bincount", [torch.ones(3, dtype=torch.long)])])
def test_data_dependent_ops_raise_under_capture(name, args):
    tdisp.call_op(name, *args)        # eagerly: fine
    with fok.deferred_tables(()):     # a capture in progress
        with pytest.raises(tman.DataDependentShapeError, match=name):
            tdisp.call_op(name, *args)


def test_reference_differentiates_what_the_port_checks():
    """The VJP cases follow the reference's table: every op it marks
    ``backward: none`` is one whose output the port returns without a
    grad path or as integers."""
    for n in ("argmax", "argsort", "nonzero", "floor_divide", "equal"):
        assert not rdisp.OPS[n].differentiable
