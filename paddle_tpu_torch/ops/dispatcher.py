"""The op registry: ``call_op(name, *args, **kwargs)`` and ``get_op(name)``.

Counterpart of ``paddle_tpu/ops/dispatcher.py`` (``register_kernel`` :64,
``call_op`` :668, ``get_op`` :690, ``build_ops`` :704), lean: the schema
is a table the port owns (argument names and defaults copied from
``paddle_tpu/ops/ops.yaml``, which the port does not read), an op binds
its arguments to that schema, drops a stray ``name=`` keyword as the
reference's op functions do (here through ``call_op`` too, whose op name
is positional-only), and calls its kernel with every argument by name.
The ops take and return ``torch.Tensor``s: no Tensor class, no jit
cache, no legacy-name table (``op_compat``), no dispatch counter.

The op choke point: every op of the registry, every op of
``ops/kernels/nn.py`` and the Llama path's tied-logits ``matmul`` and loss
``mean`` run through :func:`hooked` under the reference op's name. It is
the reference's ``_dispatch`` (:379-519) cut to its hooks: the AMP cast of
the floating inputs (``set_amp_hook``, :285), the span hook around the op
(``set_op_span_hook``, :363), the NaN/Inf check of the outputs under
``FLAGS_check_nan_inf`` (:514-519) and the tensor-stats hook on the
outputs (``set_tensor_stats_hook``, :368), and the flight recorder's entry
before the op runs (``observability/flight_recorder.py``, under
``FLAGS_flight_recorder``, where the reference's ``_dispatch_impl``
records, :484-489). With no hook set and both flags off, an op pays one
test of five module globals. The port's raw tensor
arithmetic (residual adds, reshapes, slices) does not pass through it,
where the reference dispatches every Tensor method.

The table holds each op whose reference arguments a port function takes
as they are: the attention, CE, GEMM and quantization ops, the Llama
path's ``linear``, ``embedding``, ``rms_norm``, ``swiglu`` and ``rope``,
and every op the layers of ``nn/layers_common.py`` and ``nn/loss.py``
reach (convolutions, norms, dropout, activations, pools, resizes, the
losses), and the parallel ``ring_attention`` and ``moe_ffn``.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Tuple

import torch

from .. import flags as _flags
from ..observability import flight_recorder as _flight_mod

REQUIRED = inspect.Parameter.empty

_ATTN = (("query", REQUIRED), ("key", REQUIRED), ("value", REQUIRED),
         ("attn_mask", None), ("dropout_p", 0.0), ("is_causal", False),
         ("scale", None))
_POOL = (("q", REQUIRED), ("k_pool", REQUIRED), ("v_pool", REQUIRED),
         ("block_tables", REQUIRED), ("context_lens", REQUIRED))

# op name -> (argument name, default) in the reference schema's order
SCHEMA: Dict[str, Tuple[Tuple[str, Any], ...]] = {
    "flash_attn_unpadded": (
        ("q", REQUIRED), ("k", REQUIRED), ("v", REQUIRED),
        ("cu_seqlens_q", REQUIRED), ("cu_seqlens_k", REQUIRED),
        ("max_seqlen_q", 0), ("max_seqlen_k", 0), ("scale", 0.0),
        ("causal", False)),
    "flash_attention": _ATTN,
    "scaled_dot_product_attention": _ATTN,
    "ring_attention": (("query", REQUIRED), ("key", REQUIRED),
                       ("value", REQUIRED), ("is_causal", False),
                       ("scale", None)),
    "moe_ffn": (
        ("x", REQUIRED), ("gate_weight", REQUIRED), ("gate_proj", REQUIRED),
        ("up_proj", REQUIRED), ("down_proj", REQUIRED), ("top_k", 2),
        ("capacity_factor", 1.25), ("expert_axis", "dp"),
        ("use_pallas", None)),
    "fused_softmax_ce": (("logits", REQUIRED), ("labels", REQUIRED)),
    "grouped_gemm": (
        ("x", REQUIRED), ("w", REQUIRED), ("counts", None),
        ("groups_per_expert", 1), ("use_pallas", None)),
    "weight_quantize": (
        ("x", REQUIRED), ("algo", "weight_only_int8"), ("arch", 80),
        ("group_size", -1)),
    "weight_dequantize": (
        ("x", REQUIRED), ("scale", REQUIRED), ("algo", "weight_only_int8"),
        ("out_dtype", "float32"), ("group_size", -1)),
    "weight_only_linear": (
        ("x", REQUIRED), ("weight", REQUIRED), ("bias", None),
        ("weight_scale", None), ("weight_dtype", "int8"), ("arch", 80),
        ("group_size", -1)),
    "paged_attention": _POOL + (
        ("scale", None), ("k_scale", None), ("v_scale", None)),
    "ragged_paged_attention": _POOL + (
        ("cu_q_lens", REQUIRED), ("scale", None), ("k_scale", None),
        ("v_scale", None)),
}

_X = (("x", REQUIRED),)
_NORM = _X + (("weight", None), ("bias", None), ("epsilon", 1e-05))
_CONV = (("x", REQUIRED), ("weight", REQUIRED), ("bias", None),
         ("stride", 1), ("padding", 0))
_ADAPTIVE = _X + (("output_size", REQUIRED), ("data_format", "NCHW"))
_LOSS = (("input", REQUIRED), ("label", REQUIRED))
SCHEMA.update({
    "linear": (("x", REQUIRED), ("weight", REQUIRED), ("bias", None)),
    "embedding": (("x", REQUIRED), ("weight", REQUIRED),
                  ("padding_idx", None), ("sparse", False)),
    "rms_norm": _NORM[:3] + (("epsilon", 1e-06), ("begin_norm_axis", -1)),
    "swiglu": _X + (("y", None),),
    "rope": (("q", REQUIRED), ("k", None), ("cos", None), ("sin", None),
             ("position_ids", None), ("rotate_half_style", True)),
    "layer_norm": _NORM + (("begin_norm_axis", -1),),
    "batch_norm_infer": _X + (
        ("running_mean", REQUIRED), ("running_var", REQUIRED),
        ("weight", None), ("bias", None), ("epsilon", 1e-05),
        ("data_format", "NCHW")),
    "batch_norm_train": _NORM + (("data_format", "NCHW"),),
    "group_norm": _NORM + (("groups", 1), ("data_format", "NCHW")),
    "instance_norm": _NORM,
    "conv2d": _CONV + (("dilation", 1), ("groups", 1),
                       ("data_format", "NCHW")),
    "conv1d": _CONV + (("dilation", 1), ("groups", 1),
                       ("data_format", "NCL")),
    "conv2d_transpose": _CONV + (("output_padding", 0), ("dilation", 1),
                                 ("groups", 1), ("data_format", "NCHW")),
    "max_pool2d": _X + (("kernel_size", REQUIRED), ("stride", None),
                        ("padding", 0), ("ceil_mode", False),
                        ("data_format", "NCHW")),
    "avg_pool2d": _X + (("kernel_size", REQUIRED), ("stride", None),
                        ("padding", 0), ("ceil_mode", False),
                        ("exclusive", True), ("data_format", "NCHW")),
    "adaptive_avg_pool2d": _ADAPTIVE,
    "adaptive_max_pool2d": _ADAPTIVE,
    "interpolate_nearest": _X + (("out_h", REQUIRED), ("out_w", REQUIRED),
                                 ("data_format", "NCHW")),
    "interpolate_bilinear": _X + (("out_h", REQUIRED), ("out_w", REQUIRED),
                                  ("align_corners", False),
                                  ("data_format", "NCHW")),
    "pixel_shuffle": _X + (("upscale_factor", REQUIRED),
                           ("data_format", "NCHW")),
    "flatten": _X + (("start_axis", 0), ("stop_axis", -1)),
    "pad": _X + (("pad", REQUIRED), ("mode", "constant"), ("value", 0.0),
                 ("data_format", "NCHW")),
    "one_hot": _X + (("num_classes", REQUIRED),),
    "dropout": _X + (("p", 0.5), ("training", True),
                     ("mode", "upscale_in_train")),
    "relu": _X, "relu6": _X, "selu": _X, "softsign": _X, "silu": _X,
    "swish": _X, "mish": _X, "hardswish": _X, "sigmoid": _X, "tanh": _X,
    "logsigmoid": _X,
    "elu": _X + (("alpha", 1.0),),
    "softplus": _X + (("beta", 1.0), ("threshold", 20.0)),
    "hardsigmoid": _X + (("slope", 0.16666666666666666), ("offset", 0.5)),
    "leaky_relu": _X + (("negative_slope", 0.01),),
    "prelu": _X + (("weight", REQUIRED),),
    "gelu": _X + (("approximate", False),),
    "softmax": _X + (("axis", -1),),
    "log_softmax": _X + (("axis", -1),),
    "cross_entropy_mean": (
        ("logits", REQUIRED), ("label", REQUIRED), ("soft_label", False),
        ("ignore_index", -100), ("axis", -1), ("weight", None),
        ("reduction", "mean")),
    "nll_loss": (("log_prob", REQUIRED), ("label", REQUIRED),
                 ("weight", None), ("ignore_index", -100),
                 ("reduction", "mean")),
    "mse_loss": _LOSS + (("reduction", "mean"),),
    "l1_loss": _LOSS + (("reduction", "mean"),),
    "smooth_l1_loss": _LOSS + (("reduction", "mean"), ("delta", 1.0)),
    "binary_cross_entropy": _LOSS + (("weight", None),
                                     ("reduction", "mean")),
    "binary_cross_entropy_with_logits": (
        ("logit", REQUIRED), ("label", REQUIRED), ("weight", None),
        ("pos_weight", None), ("reduction", "mean")),
    "kl_div": _LOSS + (("reduction", "mean"), ("log_target", False)),
})

# -- the core op table (creation, math, manipulation, search/sort) and the
# recurrences: ``ops.yaml`` lines 13-334, 423-426 and 686
_R = REQUIRED
_XY = (("x", _R), ("y", _R))
_SHAPE = (("shape", ()), ("dtype", None))
_LIKE = _X + (("dtype", None),)
_RED = _X + (("axis", None), ("keepdim", False))
_CLOSE = _XY + (("rtol", 1e-05), ("atol", 1e-08), ("equal_nan", False))
_DIAG = _X + (("offset", 0), ("axis1", 0), ("axis2", 1))
_ARG = _RED + (("dtype", None),)
_RNN = (("x", _R), ("w_ih", _R), ("w_hh", _R), ("b_ih", _R), ("b_hh", _R),
        ("h0", _R))
_LENGTHS = (("input_lengths", _R), ("label_lengths", _R), ("blank", 0))
UNARY_OPS = (
    "assign", "abs", "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt",
    "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "asinh", "acosh", "atanh", "floor", "ceil", "round", "trunc", "sign",
    "square", "reciprocal", "neg", "erf", "erfinv", "lgamma", "digamma",
    "frac", "conj", "angle", "real", "imag", "isnan", "isinf", "isfinite",
    "logical_not", "bitwise_not", "t", "inverse", "matrix_transpose",
    "numel", "shape_op", "as_real", "as_complex", "tanhshrink")
BINARY_OPS = (
    "add", "subtract", "multiply", "divide", "pow", "maximum", "minimum",
    "remainder", "mod", "fmod", "floor_divide", "atan2", "logaddexp",
    "hypot", "gcd", "lcm", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "logical_and", "logical_or",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "equal_all",
    "dot", "outer", "bmm", "kron")
SCHEMA.update({name: _X for name in UNARY_OPS})
SCHEMA.update({name: _XY for name in BINARY_OPS})
SCHEMA.update({
    # creation
    "full": (("shape", ()), ("fill_value", 0.0), ("dtype", None)),
    "full_like": _X + (("fill_value", 0.0), ("dtype", None)),
    "zeros": _SHAPE, "ones": _SHAPE, "empty": _SHAPE,
    "zeros_like": _LIKE, "ones_like": _LIKE, "empty_like": _LIKE,
    "arange": (("start", 0), ("end", None), ("step", 1), ("dtype", None)),
    "linspace": (("start", _R), ("stop", _R), ("num", _R), ("dtype", None)),
    "eye": (("num_rows", _R), ("num_columns", None), ("dtype", None)),
    "tril_indices": (("rows", _R), ("cols", _R), ("offset", 0)),
    "diag": _X + (("offset", 0),),
    "diagflat": _X + (("offset", 0),),
    "meshgrid": (("xs", _R),),
    "getitem": _X + (("index", None),),
    # math
    "allclose": _CLOSE, "isclose": _CLOSE,
    "scale": _X + (("scale", 1.0), ("bias", 0.0), ("bias_after_scale", True)),
    "clip": _X + (("min", None), ("max", None)),
    "lerp": _XY + (("weight", _R),),
    "addmm": (("input", _R),) + _XY + (("beta", 1.0), ("alpha", 1.0)),
    # reductions
    "sum": _X + (("axis", None), ("dtype", None), ("keepdim", False)),
    "mean": _RED, "max": _RED, "min": _RED, "any": _RED, "all": _RED,
    "logsumexp": _RED, "amax": _RED, "amin": _RED, "median": _RED,
    "nanmean": _RED, "nansum": _RED,
    "prod": _RED + (("dtype", None),),
    "std": _X + (("axis", None), ("unbiased", True), ("keepdim", False)),
    "var": _X + (("axis", None), ("unbiased", True), ("keepdim", False)),
    "cumsum": _X + (("axis", None),),
    "cumprod": _X + (("dim", None),),
    "cummax": _X + (("axis", -1),),
    "cummin": _X + (("axis", -1),),
    # linalg
    "matmul": _XY + (("transpose_x", False), ("transpose_y", False)),
    "cross": _XY + (("axis", -1),),
    "mv": _X + (("vec", _R),),
    "norm": _X + (("p", 2.0), ("axis", None), ("keepdim", False)),
    "einsum_impl": (("operands", _R), ("equation", "")),
    "triangular_solve": _XY + (("upper", True), ("transpose", False),
                               ("unitriangular", False)),
    "cholesky": _X + (("upper", False),),
    "trace": _DIAG, "diagonal": _DIAG,
    # manipulation
    "reshape": _X + (("shape", _R),),
    "transpose": _X + (("perm", _R),),
    "swapaxes": _X + (("axis1", _R), ("axis2", _R)),
    "moveaxis": _X + (("source", _R), ("destination", _R)),
    "concat": (("xs", _R), ("axis", 0)),
    "stack": (("xs", _R), ("axis", 0)),
    "split": _X + (("num_or_sections", _R), ("axis", 0)),
    "chunk": _X + (("chunks", _R), ("axis", 0)),
    "unstack": _X + (("axis", 0), ("num", None)),
    "unbind": _X + (("axis", 0),),
    "squeeze": _X + (("axis", None),),
    "unsqueeze": _X + (("axis", _R),),
    "expand": _X + (("shape", _R),),
    "broadcast_to": _X + (("shape", _R),),
    "tile": _X + (("repeat_times", _R),),
    "repeat_interleave": _X + (("repeats", _R), ("axis", None)),
    "flip": _X + (("axis", _R),),
    "roll": _X + (("shifts", _R), ("axis", None)),
    "cast": _X + (("dtype", _R),),
    "slice": _X + (("axes", _R), ("starts", _R), ("ends", _R)),
    "strided_slice": _X + (("axes", _R), ("starts", _R), ("ends", _R),
                           ("strides", _R)),
    "gather": _X + (("index", _R), ("axis", 0)),
    "gather_nd": _X + (("index", _R),),
    "take_along_axis": _X + (("indices", _R), ("axis", _R)),
    "put_along_axis": _X + (("indices", _R), ("values", _R), ("axis", _R),
                            ("reduce", "assign")),
    "scatter": _X + (("index", _R), ("updates", _R), ("overwrite", True)),
    "scatter_nd_add": _X + (("index", _R), ("updates", _R)),
    "index_select": _X + (("index", _R), ("axis", 0)),
    "index_add": _X + (("index", _R), ("axis", _R), ("value", _R)),
    "where": (("condition", _R), ("x", None), ("y", None)),
    "masked_fill": _X + (("mask", _R), ("value", _R)),
    "tril": _X + (("diagonal", 0),),
    "triu": _X + (("diagonal", 0),),
    # search / sort
    "argmax": _ARG, "argmin": _ARG,
    "argsort": _X + (("axis", -1), ("descending", False), ("stable", True)),
    "sort": _X + (("axis", -1), ("descending", False)),
    "topk": _X + (("k", _R), ("axis", -1), ("largest", True),
                  ("sorted", True)),
    "searchsorted": (("sorted_sequence", _R), ("values", _R),
                     ("out_int32", False), ("right", False)),
    "bincount": _X + (("weights", None), ("minlength", 0)),
    "histogram": _X + (("bins", 100), ("min", 0.0), ("max", 0.0)),
    "nonzero": _X + (("as_tuple", False),),
    "masked_select": _X + (("mask", _R),),
    "unique": _X + (("return_index", False), ("return_inverse", False),
                    ("return_counts", False), ("axis", None)),
    # activations, nn core, losses
    "celu": _X + (("alpha", 1.0),),
    "hardtanh": _X + (("min", -1.0), ("max", 1.0)),
    "softshrink": _X + (("threshold", 0.5),),
    "hardshrink": _X + (("threshold", 0.5),),
    "thresholded_relu": _X + (("threshold", 1.0),),
    "glu": _X + (("axis", -1),),
    "gumbel_softmax": _X + (("temperature", 1.0), ("hard", False),
                            ("axis", -1)),
    "unfold": _X + (("kernel_sizes", _R), ("strides", 1), ("paddings", 0),
                    ("dilations", 1)),
    "softmax_with_cross_entropy": (
        ("logits", _R), ("label", _R), ("soft_label", False),
        ("ignore_index", -100), ("axis", -1)),
    "cosine_similarity": (("x1", _R), ("x2", _R), ("axis", 1),
                          ("eps", 1e-08)),
    "hinge_embedding_loss": _LOSS + (("margin", 1.0), ("reduction", "mean")),
    # recurrences and sequence losses
    "lstm_layer": _RNN + (("c0", _R), ("lens", None), ("reverse", False)),
    "gru_layer": _RNN + (("lens", None), ("reverse", False)),
    "simple_rnn_layer": _RNN + (("lens", None), ("reverse", False),
                                ("activation", "tanh")),
    "ctc_loss": (("log_probs", _R), ("labels", _R)) + _LENGTHS + (
        ("norm_by_times", False),),
    "rnnt_loss": (("input", _R), ("label", _R)) + _LENGTHS + (
        ("fastemit_lambda", 0.0),),
})

# -- the Tensor surface's ops: the method ops of ``math_ext.py`` /
# ``extra_math.py``, the inplace bases, the random ops (``key: true``) and
# the ops of ``ops.yaml:809-819``
_AX = _X + (("axis", None), ("keepdim", False))
_SPLIT = _X + (("num_or_indices", 2),)
_RND = (("shape", ()), ("dtype", None))
SCHEMA.update({name: _X for name in (
    "deg2rad", "rad2deg", "signbit", "sgn", "isneginf", "isposinf",
    "isreal", "i0", "i0e", "i1", "i1e", "frexp", "gammaln", "bernoulli",
    "poisson", "shuffle_batch", "standard_gamma")})
SCHEMA.update({name: _XY for name in (
    "heaviside", "copysign", "ldexp", "expand_as", "gammainc", "gammaincc",
    "nextafter", "bitwise_left_shift", "bitwise_right_shift", "fmax",
    "fmin", "inner")})
SCHEMA.update({
    # statistics, math, search and manipulation (Tensor methods)
    "quantile": _X + (("q", 0.5), ("axis", None), ("keepdim", False),
                      ("interpolation", "linear")),
    "kthvalue": _X + (("k", 1), ("axis", -1), ("keepdim", False)),
    "mode": _X + (("axis", -1), ("keepdim", False)),
    "count_nonzero": _AX, "nanmedian": _AX,
    "logcumsumexp": _X + (("axis", None),),
    "renorm": _X + (("p", 2.0), ("axis", 0), ("max_norm", 1.0)),
    "diff": _X + (("n", 1), ("axis", -1)),
    "nan_to_num": _X + (("nan", 0.0), ("posinf", None), ("neginf", None)),
    "logit": _X + (("eps", None),),
    "take": _X + (("index", _R), ("mode", "raise")),
    "bucketize": _X + (("sorted_sequence", _R), ("out_int32", False),
                       ("right", False)),
    "index_fill": _X + (("index", _R), ("axis", 0), ("value", 0.0)),
    "masked_scatter": _X + (("mask", _R), ("value", _R)),
    "rot90": _X + (("k", 1), ("axes", (0, 1))),
    "unflatten": _X + (("axis", 0), ("shape", ())),
    "view_as": _X + (("other", _R),),
    "increment": _X + (("value", 1.0),),
    "tensor_split": _SPLIT + (("axis", 0),),
    "hsplit": _SPLIT, "vsplit": _SPLIT, "dsplit": _SPLIT,
    "fill_diagonal": _X + (("value", 0.0), ("offset", 0), ("wrap", False)),
    "polygamma": _X + (("n", 1),),
    "multigammaln": _X + (("p", 1),),
    "reverse": _X + (("axis", ()),),
    "index_sample": _X + (("index", _R),),
    "index_put": _X + (("indices", _R), ("value", _R),
                       ("accumulate", False)),
    "as_strided": _X + (("shape", ()), ("stride", ()), ("offset", 0)),
    "tensor_unfold": _X + (("axis", 0), ("size", 1), ("step", 1)),
    "fill": _X + (("value", 0.0),),
    # random
    "uniform": _RND + (("min", 0.0), ("max", 1.0)),
    "gaussian": (("shape", ()), ("mean", 0.0), ("std", 1.0),
                 ("dtype", None)),
    "rand": _RND, "randn": _RND,
    "randint": (("low", 0), ("high", None), ("shape", ()), ("dtype", None)),
    "randperm": (("n", _R), ("dtype", None)),
    "truncated_gaussian_random": (
        ("shape", ()), ("mean", 0.0), ("std", 1.0), ("a", -2.0), ("b", 2.0),
        ("dtype", "float32")),
    "multinomial": _X + (("num_samples", 1), ("replacement", False)),
    "normal_like": _X + (("mean", 0.0), ("std", 1.0)),
    "uniform_like": _X + (("min", -1.0), ("max", 1.0)),
    "exponential": _X + (("lam", 1.0),),
    "cauchy_like": _X + (("loc", 0.0), ("scale", 1.0)),
    "geometric_like": _X + (("probs", 0.5),),
    "shuffle": _X + (("axis", 0),),
    "rrelu": _X + (("lower", 0.125), ("upper", 0.333333),
                   ("is_test", False)),
    "binomial": (("count", _R), ("prob", _R)),
    "dirichlet": (("alpha", _R),),
    "fused_dropout_add": _XY + (("p", 0.5), ("training", True),
                                ("mode", "upscale_in_train")),
    "uniform_random_batch_size_like": (
        ("input", _R), ("shape", ()), ("min", -1.0), ("max", 1.0),
        ("dtype", None), ("input_dim_idx", 0), ("output_dim_idx", 0)),
    "pca_lowrank": _X + (("q", None), ("center", True), ("niter", 2)),
    # the differentiable forms of tensor_api's long tail
    "tensordot_impl": _XY + (("axes_x", ()), ("axes_y", ())),
    "pdist": _X + (("p", 2.0),),
    "cumulative_trapezoid": (("y", _R), ("x", None), ("dx", None),
                             ("axis", -1)),
    "combinations": _X + (("r", 2), ("with_replacement", False)),
    "diagonal_scatter": _XY + (("offset", 0), ("axis1", 0), ("axis2", 1)),
    "select_scatter": _X + (("values", _R), ("axis", 0), ("index", 0)),
    "slice_scatter": _X + (("value", _R), ("axes", ()), ("starts", ()),
                           ("ends", ()), ("strides", ())),
    "scatter_nd": (("index", _R), ("updates", _R), ("shape", ())),
})

# -- the vision tranche: ``ops.yaml:544-576`` and ``:656`` (``extra_nn.py``),
# ``:660-668`` and ``:542`` (``detection.py``), ``:718-719`` (``vision_io.py``)
_FMT = lambda f: (("data_format", f),)  # noqa: E731
_INTERP = _X + (("size", None), ("scale_factor", None),
                ("align_corners", False))
_POOLND = _X + (("kernel_size", ()), ("strides", ()))
_POOL_REST = (("pooling_type", "max"), ("ceil_mode", False),
              ("exclusive", True), ("adaptive", False),
              ("global_pooling", False))
_WITH_INDEX = (("global_pooling", False), ("adaptive", False))
_UNPOOL = (("x", _R), ("indices", _R), ("kernel_size", ()), ("strides", ()))
_ROI = (("x", _R), ("boxes", _R), ("boxes_num", None),
        ("pooled_height", 1), ("pooled_width", 1))
_NMS_OUT = (("score_threshold", 0.0), ("nms_top_k", -1), ("keep_top_k", -1))
_BN = _X + (("mean", _R), ("variance", _R), ("scale", None), ("bias", None),
            ("is_test", False), ("momentum", 0.9), ("epsilon", 1e-05),
            ("data_format", "NCHW"), ("use_global_stats", False))
SCHEMA.update({
    "grid_sample": _X + (("grid", _R), ("mode", "bilinear"),
                         ("padding_mode", "zeros"), ("align_corners", True)),
    "affine_grid": (("theta", _R), ("output_shape", ()),
                    ("align_corners", True)),
    "pixel_unshuffle": _X + (("downscale_factor", 1),) + _FMT("NCHW"),
    "channel_shuffle": _X + (("groups", 1),) + _FMT("NCHW"),
    "temporal_shift": _X + (("seg_num", 1), ("shift_ratio", 0.25)) +
    _FMT("NCHW"),
    "maxout": _X + (("groups", 1), ("axis", 1)),
    "pad3d": _X + (("paddings", ()), ("mode", "constant"), ("value", 0.0)) +
    _FMT("NCDHW"),
    "pool2d": _POOLND + (("paddings", (0, 0)),) + _POOL_REST + _FMT("NCHW"),
    "pool3d": _POOLND + (("paddings", (0, 0, 0)),) + _POOL_REST +
    _FMT("NCDHW"),
    "max_pool2d_with_index": _POOLND + (("paddings", (0, 0)),) + _WITH_INDEX,
    "max_pool3d_with_index": _POOLND + (("paddings", (0, 0, 0)),) +
    _WITH_INDEX,
    "unpool": _UNPOOL + (("paddings", (0, 0)), ("output_size", ())),
    "unpool3d": _UNPOOL + (("paddings", (0, 0, 0)), ("output_size", ())),
    "fold": _X + (("output_sizes", ()), ("kernel_sizes", ()),
                  ("strides", (1, 1)), ("paddings", (0, 0)),
                  ("dilations", (1, 1))),
    "fractional_max_pool2d": _X + (("output_size", ()), ("kernel_size", None),
                                   ("random_u", 0.5), ("return_mask", False)),
    "conv3d": _X + (("weight", _R), ("stride", (1, 1, 1)),
                    ("padding", (0, 0, 0)), ("dilation", (1, 1, 1)),
                    ("groups", 1)) + _FMT("NCDHW"),
    "conv3d_transpose": _X + (("weight", _R), ("stride", (1, 1, 1)),
                              ("padding", (0, 0, 0)),
                              ("output_padding", (0, 0, 0)),
                              ("dilation", (1, 1, 1)), ("groups", 1)) +
    _FMT("NCDHW"),
    "bilinear_interp": _INTERP + _FMT("NCHW"),
    "nearest_interp": _INTERP + _FMT("NCHW"),
    "bicubic_interp": _INTERP + _FMT("NCHW"),
    "linear_interp": _INTERP + _FMT("NCW"),
    "trilinear_interp": _INTERP + _FMT("NCDHW"),
    "spectral_norm": (("weight", _R), ("u", _R), ("v", _R), ("dim", 0),
                      ("power_iters", 1), ("eps", 1e-12)),
    "segment_pool": _X + (("segment_ids", _R), ("pooltype", "SUM")),
    "overlap_add": _X + (("hop_length", 1), ("axis", -1)),
    "box_coder": (("prior_box", _R), ("prior_box_var", None),
                  ("target_box", None), ("code_type", "encode_center_size"),
                  ("box_normalized", True), ("axis", 0)),
    "roi_align": _ROI + (("spatial_scale", 1.0), ("sampling_ratio", -1),
                         ("aligned", True)),
    "roi_pool": _ROI + (("spatial_scale", 1.0),),
    "prior_box": (("input", _R), ("image", _R), ("min_sizes", ()),
                  ("max_sizes", ()), ("aspect_ratios", (1.0,)),
                  ("variances", (0.1, 0.1, 0.2, 0.2)), ("flip", False),
                  ("clip", False), ("steps", (0.0, 0.0)), ("offset", 0.5),
                  ("min_max_aspect_ratios_order", False)),
    "batch_norm": _BN,
    "sync_batch_norm": _BN,
    "yolo_box": _X + (("img_size", _R), ("anchors", ()), ("class_num", 1),
                      ("conf_thresh", 0.01), ("downsample_ratio", 32),
                      ("clip_bbox", True), ("scale_x_y", 1.0),
                      ("iou_aware", False), ("iou_aware_factor", 0.5)),
    "yolo_loss": _X + (("gt_box", _R), ("gt_label", _R), ("gt_score", None),
                       ("anchors", ()), ("anchor_mask", ()), ("class_num", 1),
                       ("ignore_thresh", 0.7), ("downsample_ratio", 32),
                       ("use_label_smooth", True), ("scale_x_y", 1.0)),
    "deformable_conv": _X + (("offset", _R), ("filter", _R), ("mask", None),
                             ("strides", (1, 1)), ("paddings", (0, 0)),
                             ("dilations", (1, 1)), ("deformable_groups", 1),
                             ("groups", 1), ("im2col_step", 64)),
    "psroi_pool": _ROI + (("output_channels", 1), ("spatial_scale", 1.0)),
    "multiclass_nms3": (("bboxes", _R), ("scores", _R), ("rois_num", None)) +
    _NMS_OUT + (("nms_threshold", 0.3), ("normalized", True),
                ("nms_eta", 1.0), ("background_label", 0)),
    "matrix_nms": (("bboxes", _R), ("scores", _R)) + _NMS_OUT + (
        ("post_threshold", 0.0), ("use_gaussian", False),
        ("gaussian_sigma", 2.0), ("background_label", 0),
        ("normalized", True)),
    "generate_proposals": (
        ("scores", _R), ("bbox_deltas", _R), ("im_shape", _R),
        ("anchors", _R), ("variances", _R), ("pre_nms_top_n", 6000),
        ("post_nms_top_n", 1000), ("nms_thresh", 0.5), ("min_size", 0.1),
        ("eta", 1.0), ("pixel_offset", True)),
    "distribute_fpn_proposals": (
        ("fpn_rois", _R), ("rois_num", None), ("min_level", 2),
        ("max_level", 5), ("refer_level", 4), ("refer_scale", 224),
        ("pixel_offset", True)),
    "nms": (("boxes", _R), ("scores", None), ("iou_threshold", 0.3)),
    "read_file": (("filename", ""),),
    "decode_jpeg": _X + (("mode", "unchanged"),),
})

# -- the serving slice: ``ops.yaml:429-432``, ``:435-436`` (``serving.py``)
# and ``:619`` (``extra_misc.py``)
_SAMPLE = (("temperature", 1.0), ("top_k", 0), ("top_p", 1.0))
SCHEMA.update({
    "cache_write": (("cache", _R), ("new", _R), ("pos", _R)),
    "cache_attention": (("q", _R), ("k_cache", _R), ("v_cache", _R),
                        ("pos", _R), ("attn_mask", None), ("scale", None)),
    "paged_cache_write": (("pool", _R), ("new", _R), ("slot_ids", _R)),
    "paged_cache_write_q": (("pool", _R), ("scale_pool", _R), ("new", _R),
                            ("slot_ids", _R)),
    "sample_logits": (("logits", _R),) + _SAMPLE,
    "sample_logits_keyed": (("logits", _R), ("key_data", _R),
                            ("stream_pos", _R)) + _SAMPLE,
    "top_p_sampling": _X + (("ps", _R), ("threshold", None)),
})

# -- the linalg, fft and signal entries (``ops.yaml:372-417``, ``:622-626``),
# the rest of the extended tranche (``:438-494``), the round-2 math tranche
# (``:496-543``), the graph ops (``:680-685``) and ``viterbi_decode``
# (``:658``)
_UPLO = _X + (("UPLO", "L"),)
_FFT = _X + (("n", None), ("axis", -1), ("norm", "backward"))
_FFT2 = _X + (("s", None), ("axes", (-2, -1)), ("norm", "backward"))
_FFTN = _X + (("s", None), ("axes", None), ("norm", "backward"))
_FREQ = (("n", 1), ("d", 1.0), ("dtype", None))
_XS = (("xs", _R),)
_FFT_K = _X + (("axes", (-1,)), ("normalization", "backward"))
_INPUT_LABEL = (("input", _R), ("label", _R))
_SRC_DST = (("src_index", _R), ("dst_index", _R))
SCHEMA.update({
    # linalg decompositions
    "svd": _X + (("full_matrices", False),),
    "qr": _X + (("mode", "reduced"),),
    "eigh": _UPLO, "eigvalsh": _UPLO, "eig": _X, "eigvals": _X, "lu": _X,
    "det": _X, "slogdet": _X,
    "pinv": _X + (("rcond", 1e-15), ("hermitian", False)),
    "matrix_power": _X + (("n", 1),),
    "matrix_rank": _X + (("tol", None), ("hermitian", False)),
    "solve": _XY,
    "lstsq": _XY + (("rcond", None), ("driver", None)),
    "cholesky_solve": _XY + (("upper", False),),
    "cond": _X + (("p", None),),
    "cov": _X + (("rowvar", True), ("ddof", True), ("fweights", None),
                 ("aweights", None)),
    "corrcoef": _X + (("rowvar", True),),
    "multi_dot": _XS,
    "householder_product": _X + (("tau", _R),),
    "matrix_norm": _X + (("p", "fro"), ("axis", (-2, -1)),
                         ("keepdim", False)),
    "lu_unpack": _XY + (("unpack_ludata", True), ("unpack_pivots", True)),
    "fft_c2c": _FFT_K + (("forward", True),),
    "fft_r2c": _FFT_K + (("forward", True), ("onesided", True)),
    "fft_c2r": _FFT_K + (("forward", False), ("last_dim_size", 0)),
    # fft
    **{name: _FFT for name in ("fft", "ifft", "rfft", "irfft", "hfft",
                               "ihfft")},
    **{name: _FFT2 for name in ("fft2", "ifft2", "rfft2", "irfft2")},
    "fftn": _FFTN, "ifftn": _FFTN,
    "fftshift": _X + (("axes", None),), "ifftshift": _X + (("axes", None),),
    "fftfreq": _FREQ, "rfftfreq": _FREQ,
    # signal
    "frame": _X + (("frame_length", 512), ("hop_length", 128), ("axis", -1)),
    "stft": _X + (("n_fft", 512), ("hop_length", None), ("win_length", None),
                  ("window", None), ("center", True), ("pad_mode", "reflect"),
                  ("normalized", False), ("onesided", True)),
    "istft": _X + (("n_fft", 512), ("hop_length", None),
                   ("win_length", None), ("window", None), ("center", True),
                   ("normalized", False), ("onesided", True),
                   ("length", None), ("return_complex", False)),
    # the rest of the extended tranche
    "nanquantile": _X + (("q", 0.5), ("axis", None), ("keepdim", False),
                         ("interpolation", "linear")),
    "vander": _X + (("n", None), ("increasing", False)),
    "trapezoid": (("y", _R), ("x", None), ("dx", 1.0), ("axis", -1)),
    "polar": (("abs", _R), ("angle", _R)),
    "cdist": _XY + (("p", 2.0),),
    "crop": _X + (("shape", ()), ("offsets", None)),
    "block_diag": _XS, "broadcast_tensors": _XS, "column_stack": _XS,
    "hstack": _XS, "vstack": _XS, "dstack": _XS, "row_stack": _XS,
    "atleast_1d": _X, "atleast_2d": _X, "atleast_3d": _X,
    "diag_embed": _X + (("offset", 0), ("dim1", -2), ("dim2", -1)),
    "gather_tree": (("ids", _R), ("parents", _R)),
    # the round-2 math tranche
    "stanh": _X + (("scale_a", 0.67), ("scale_b", 1.7159)),
    "tanh_shrink": _X,
    "logspace": (("start", _R), ("stop", _R), ("num", _R), ("base", 10.0),
                 ("dtype", None)),
    "complex": (("real", _R), ("imag", _R)),
    "dist": _XY + (("p", 2.0),),
    "p_norm": _X + (("porder", 2.0), ("axis", -1), ("epsilon", 1e-12),
                    ("keepdim", False), ("asvector", False)),
    "frobenius_norm": _X + (("axis", None), ("keepdim", False)),
    "squared_l2_norm": _X,
    "clip_by_norm": _X + (("max_norm", 1.0),),
    "add_n": (("inputs", _R),),
    "mean_all": _X,
    "label_smooth": (("label", _R), ("prior_dist", None), ("epsilon", 0.1)),
    "huber_loss": _INPUT_LABEL + (("delta", 1.0),),
    "bce_loss": _INPUT_LABEL,
    "kldiv_loss": _X + (("label", _R), ("reduction", "mean"),
                        ("log_target", False)),
    "log_loss": _INPUT_LABEL + (("epsilon", 0.0001),),
    "sigmoid_cross_entropy_with_logits": _X + (
        ("label", _R), ("pos_weight", None), ("normalize", False),
        ("ignore_index", -100)),
    "accuracy": _X + (("label", _R), ("k", 1)),
    "is_empty": _X,
    "fill_": _X + (("value", 0.0),),
    "assign_value": (("shape", ()), ("dtype", "float32"), ("values", ())),
    "unique_consecutive": _X + (("return_inverse", False),
                                ("return_counts", False), ("axis", None),
                                ("dtype", "int64")),
    "repeat_interleave_with_tensor_index": _X + (("repeats", _R),
                                                 ("axis", 0)),
    "shard_index": (("input", _R), ("index_num", _R), ("nshards", _R),
                    ("shard_id", _R), ("ignore_value", -1)),
    "edit_distance": (("hyps", _R), ("refs", _R), ("hypslength", None),
                      ("refslength", None), ("normalized", True)),
    "view_dtype": _X + (("dtype", _R),),
    "set_value": _X + (("value", None), ("starts", ()), ("ends", ()),
                       ("steps", ()), ("axes", ()), ("shape", ())),
    "einsum": (("operands", _R), ("equation", "")),
    # graph learning
    "send_u_recv": _X + _SRC_DST + (("reduce_op", "SUM"), ("out_size", 0)),
    "send_ue_recv": _XY + _SRC_DST + (("message_op", "ADD"),
                                      ("reduce_op", "SUM"), ("out_size", 0)),
    "send_uv": _XY + _SRC_DST + (("message_op", "ADD"),),
    "graph_sample_neighbors": (
        ("row", _R), ("colptr", _R), ("x", _R), ("eids", None),
        ("perm_buffer", None), ("sample_size", -1), ("return_eids", False),
        ("flag_perm_buffer", False)),
    "weighted_sample_neighbors": (
        ("row", _R), ("colptr", _R), ("edge_weight", _R),
        ("input_nodes", _R), ("eids", None), ("sample_size", -1),
        ("return_eids", False)),
    "reindex_graph": _X + (("neighbors", _R), ("count", _R),
                           ("hashtable_value", None),
                           ("hashtable_index", None)),
    "viterbi_decode": (("potentials", _R), ("transition", _R),
                       ("lengths", None), ("include_bos_eos_tag", True)),
})

# -- the registry's last single-device entries: the op forms of
# ``ops.yaml:577-620`` (``extra_misc.py``: the optimizer updates, amp, the
# local ``c_*`` ops, the fused ops), the compat tranche (``:689-715``,
# ``compat_tranche.py``), ``fake_quantize`` (``:420``) and
# ``llm_int8_linear`` (``:674``, ``quant.py``)
_PG = (("param", _R), ("grad", _R))
_MP = (("multi_precision", False),)
_ADAM = _PG + (("learning_rate", _R), ("moment1", _R), ("moment2", _R),
               ("beta1_pow", _R), ("beta2_pow", _R), ("master_param", None))
_TRANSPOSE_CONV = (("stride", (1, 1)), ("padding", (0, 0)),
                   ("output_padding", (0, 0)), ("dilation", (1, 1)),
                   ("groups", 1), ("data_format", "NCHW"))
SCHEMA.update({
    # functional optimizer updates
    "sgd_op": (("param", _R), ("learning_rate", _R), ("grad", _R),
               ("master_param", None)) + _MP,
    "momentum_op": _PG + (("velocity", _R), ("learning_rate", _R),
                          ("master_param", None), ("mu", 0.9),
                          ("use_nesterov", False),
                          ("regularization_method", ""),
                          ("regularization_coeff", 0.0)) + _MP + (
        ("rescale_grad", 1.0),),
    "adam_op": _ADAM + (("skip_update", None), ("beta1", 0.9),
                        ("beta2", 0.999), ("epsilon", 1e-08),
                        ("lazy_mode", False)) + _MP,
    "adamw_op": _ADAM + (("skip_update", None), ("beta1", 0.9),
                         ("beta2", 0.999), ("epsilon", 1e-08),
                         ("lr_ratio", 1.0), ("coeff", 0.01),
                         ("with_decay", True)) + _MP,
    "adagrad_op": _PG + (("moment", _R), ("learning_rate", _R),
                         ("master_param", None), ("epsilon", 1e-06)) + _MP,
    "adadelta_op": _PG + (("avg_squared_grad", _R),
                          ("avg_squared_update", _R),
                          ("learning_rate", None), ("master_param", None),
                          ("rho", 0.95), ("epsilon", 1e-06)) + _MP,
    "adamax_op": _PG + (("learning_rate", _R), ("moment", _R),
                        ("inf_norm", _R), ("beta1_pow", _R),
                        ("master_param", None), ("beta1", 0.9),
                        ("beta2", 0.999), ("epsilon", 1e-08)) + _MP,
    "rmsprop_op": (("param", _R), ("mean_square", _R), ("grad", _R),
                   ("moment", _R), ("learning_rate", _R),
                   ("mean_grad", None), ("master_param", None),
                   ("epsilon", 1e-10), ("decay", 0.9), ("momentum", 0.0),
                   ("centered", False)) + _MP,
    "lamb_op": _ADAM + (("weight_decay", 0.01), ("beta1", 0.9),
                        ("beta2", 0.999), ("epsilon", 1e-06),
                        ("always_adapt", False)) + _MP,
    "asgd_op": _PG + (("learning_rate", _R), ("d", _R), ("y", _R),
                      ("n", _R), ("master_param", None)) + _MP,
    "rprop_op": _PG + (("prev", _R), ("learning_rate", _R),
                       ("master_param", None),
                       ("learning_rate_range", (1e-06, 50.0)),
                       ("etas", (0.5, 1.2))) + _MP,
    # amp
    "check_finite_and_unscale_op": (("xs", _R), ("scale", _R)),
    "update_loss_scaling_op": (
        ("xs", _R), ("found_infinite", _R), ("prev_loss_scaling", _R),
        ("in_good_steps", _R), ("in_bad_steps", _R),
        ("incr_every_n_steps", 1000), ("decr_every_n_nan_or_inf", 2),
        ("incr_ratio", 2.0), ("decr_ratio", 0.5), ("stop_update", False)),
    # the c_* ops in their local forms
    "c_identity": _X + (("ring_id", 0), ("use_calc_stream", True),
                        ("use_model_parallel", True)),
    "c_concat": _X + (("rank", 0), ("nranks", 1), ("ring_id", 0)),
    "c_allreduce_sum": _X + (("ring_id", 0), ("use_calc_stream", True)),
    "c_allreduce_max": _X + (("ring_id", 0), ("use_calc_stream", True)),
    "c_allreduce_min": _X + (("ring_id", 0), ("use_calc_stream", True)),
    "c_allreduce_prod": _X + (("ring_id", 0), ("use_calc_stream", True)),
    "c_broadcast": _X + (("root", 0), ("ring_id", 0)),
    "c_embedding": (("table", _R), ("ids", _R), ("start_index", 0),
                    ("vocab_size", -1)),
    # fused ops
    "fused_softmax_mask": _X + (("mask", _R),),
    "fused_softmax_mask_upper_triangle": _X,
    "fused_gemm_epilogue": _XY + (("bias", _R), ("trans_x", False),
                                  ("trans_y", False),
                                  ("activation", "none")),
    "fused_bias_act": _X + (("bias", None), ("act_method", "gelu")),
    "fused_linear_param_grad_add": _X + (
        ("dout", _R), ("dweight", None), ("dbias", None),
        ("multi_precision", True), ("has_bias", True)),
    "memory_efficient_attention": (
        ("query", _R), ("key", _R), ("value", _R), ("attn_mask", None),
        ("dropout_p", 0.0), ("scale", None), ("is_causal", False)),
    # the compat tranche
    "lrn": _X + (("n", 5), ("k", 1.0), ("alpha", 0.0001), ("beta", 0.75),
                 ("data_format", "NCHW")),
    "multiplex": (("inputs", _R), ("index", _R)),
    "fill_diagonal_tensor": _XY + (("offset", 0), ("dim1", 0), ("dim2", 1)),
    "grad_add": _XY,
    "fc": (("input", _R), ("w", _R), ("bias", None), ("in_num_col_dims", 1),
           ("activation_type", "")),
    "identity_loss": _X + (("reduction", 1),),
    "shuffle_channel": _X + (("group", 1),),
    "soft_relu": _X + (("threshold", 40.0),),
    "partial_sum": (("xs", _R), ("start_index", 0), ("length", -1)),
    "bilinear": _XY + (("weight", _R), ("bias", None)),
    "sequence_mask_op": _X + (("max_len", 0), ("out_dtype", "int64")),
    "number_count": (("numbers", _R), ("upper_range", 1)),
    "seed_op": (("seed", 0), ("deterministic", False), ("force_cpu", False)),
    "full_batch_size_like": (("input", _R), ("shape", ()), ("value", 0.0),
                             ("dtype", None), ("input_dim_idx", 0),
                             ("output_dim_idx", 0)),
    "row_conv": _X + (("filter", _R),),
    "fused_elemwise_add_activation": _XY + (("functor_list", ("relu",)),),
    "margin_cross_entropy": (
        ("logits", _R), ("label", _R), ("return_softmax", False),
        ("ring_id", 0), ("rank", 0), ("nranks", 1), ("margin1", 1.0),
        ("margin2", 0.5), ("margin3", 0.0), ("scale", 64.0)),
    "hsigmoid_loss": _X + (("label", _R), ("w", _R), ("bias", None),
                           ("path", None), ("code", None),
                           ("num_classes", 2), ("is_sparse", False)),
    "graph_khop_sampler": (("row", _R), ("colptr", _R), ("x", _R),
                           ("eids", None), ("sample_sizes", ()),
                           ("return_eids", False)),
    "lars_momentum_op": _PG + (("velocity", _R), ("learning_rate", _R),
                               ("mu", 0.9), ("lars_coeff", 0.001),
                               ("lars_weight_decay", 0.0005),
                               ("epsilon", 0.0), ("rescale_grad", 1.0)),
    "share_data": _X,
    "depthwise_conv2d_transpose": _X + (("weight", _R), ("bias", None)) +
    _TRANSPOSE_CONV,
    # quantization
    "fake_quantize": _X + (("scale", _R), ("bit_length", 8)),
    "llm_int8_linear": _X + (("weight", _R), ("bias", None),
                             ("weight_scale", None), ("threshold", 6.0)),
})

# ops whose first argument is not a tensor: no Tensor method
NOT_TENSOR_FIRST = frozenset({
    "full", "zeros", "ones", "empty", "arange", "linspace", "eye",
    "tril_indices", "uniform", "gaussian", "rand", "randn", "randint",
    "randperm", "truncated_gaussian_random", "read_file", "logspace",
    "fftfreq", "rfftfreq", "assign_value", "seed_op"})

# ops that live only in their namespace (``paddle_tpu_torch.fft`` /
# ``.signal``), never at the top level, where ``fft`` is the module (the
# reference maps them to None, ``paddle_tpu/__init__.py:39-49``)
NAMESPACED = frozenset({
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
    "rfft2", "irfft2", "fftn", "ifftn", "fftshift", "ifftshift", "fftfreq",
    "rfftfreq", "frame", "stft", "istft"})

# the inplace family (``ops.yaml:628-657``, ``:728-808``): name -> base op
INPLACE = {
    "fill_": "fill", "exponential_": "exponential", "exp_": "exp",
    "sqrt_": "sqrt", "rsqrt_": "rsqrt", "tanh_": "tanh",
    "sigmoid_": "sigmoid", "relu_": "relu", "clip_": "clip",
    "scale_": "scale", "add_": "add", "subtract_": "subtract",
    "multiply_": "multiply", "divide_": "divide", "remainder_": "remainder",
    "floor_": "floor", "ceil_": "ceil", "round_": "round", "trunc_": "trunc",
    "reciprocal_": "reciprocal", "erfinv_": "erfinv", "lerp_": "lerp",
    "zero_": "fill", "normal_": "normal_like", "flatten_": "flatten",
    "reshape_": "reshape", "squeeze_": "squeeze", "unsqueeze_": "unsqueeze",
    "abs_": "abs", "acos_": "acos", "acosh_": "acosh", "addmm_": "addmm",
    "asin_": "asin", "asinh_": "asinh", "atan_": "atan", "atanh_": "atanh",
    "bitwise_and_": "bitwise_and",
    "bitwise_left_shift_": "bitwise_left_shift",
    "bitwise_not_": "bitwise_not", "bitwise_or_": "bitwise_or",
    "bitwise_right_shift_": "bitwise_right_shift",
    "bitwise_xor_": "bitwise_xor", "cast_": "cast", "cauchy_": "cauchy_like",
    "copysign_": "copysign", "cos_": "cos", "cosh_": "cosh",
    "cumprod_": "cumprod", "cumsum_": "cumsum", "digamma_": "digamma",
    "erf_": "erf", "expm1_": "expm1", "equal_": "equal",
    "floor_divide_": "floor_divide", "floor_mod_": "remainder",
    "frac_": "frac", "gammainc_": "gammainc", "gammaincc_": "gammaincc",
    "gammaln_": "gammaln", "gcd_": "gcd", "geometric_": "geometric_like",
    "greater_equal_": "greater_equal", "greater_than_": "greater_than",
    "hypot_": "hypot", "i0_": "i0", "lcm_": "lcm", "ldexp_": "ldexp",
    "less_equal_": "less_equal", "less_than_": "less_than",
    "lgamma_": "lgamma", "log_": "log", "log10_": "log10", "log2_": "log2",
    "logical_and_": "logical_and", "logical_not_": "logical_not",
    "logical_or_": "logical_or", "logical_xor_": "logical_xor",
    "logit_": "logit", "masked_fill_": "masked_fill",
    "masked_scatter_": "masked_scatter", "mod_": "remainder",
    "multigammaln_": "multigammaln", "nan_to_num_": "nan_to_num",
    "neg_": "neg", "not_equal_": "not_equal", "polygamma_": "polygamma",
    "pow_": "pow", "renorm_": "renorm", "scatter_": "scatter",
    "sin_": "sin", "sinh_": "sinh", "square_": "square", "t_": "t",
    "tan_": "tan", "transpose_": "transpose", "tril_": "tril",
    "triu_": "triu", "uniform_": "uniform_like", "log1p_": "log1p",
    "index_fill_": "index_fill", "index_put_": "index_put",
    "put_along_axis_": "put_along_axis",
}

KERNELS: Dict[str, Callable] = {}
_OP_FNS: Dict[str, Callable] = {}

# -- the op choke point -------------------------------------------------------
# amp hook: (op name, [args...]) -> the args with floating tensors cast
_AMP_HOOK = None
# span hook: op name -> a context manager around the op
_OP_SPAN_HOOK = None
# tensor-stats hook: (op name, (output tensors...)) -> None
_TENSOR_STATS_HOOK = None
_FLAG_VALUES = _flags._VALUES
_FLIGHT = _flight_mod.recorder()      # resized in place by its flag


def set_amp_hook(fn) -> None:
    global _AMP_HOOK
    _AMP_HOOK = fn


def set_op_span_hook(fn) -> None:
    global _OP_SPAN_HOOK
    _OP_SPAN_HOOK = fn


def set_tensor_stats_hook(fn) -> None:
    global _TENSOR_STATS_HOOK
    _TENSOR_STATS_HOOK = fn


def _outputs(res) -> Tuple[torch.Tensor, ...]:
    items = res if isinstance(res, (tuple, list)) else (res,)
    return tuple(t for t in items if isinstance(t, torch.Tensor))


def _run_hooked(name: str, fn: Callable, args, kwargs):
    if _AMP_HOOK is not None:
        keys = list(kwargs)
        cast = _AMP_HOOK(name, list(args) + [kwargs[k] for k in keys])
        args = tuple(cast[:len(args)])
        kwargs = dict(zip(keys, cast[len(args):]))
    span = _OP_SPAN_HOOK
    if span is not None:
        with span(name):
            res = fn(*args, **kwargs)
    else:
        res = fn(*args, **kwargs)
    if _FLAG_VALUES["check_nan_inf"]:
        for o in _outputs(res):
            if (o.is_floating_point()
                    and not bool(torch.isfinite(o).all())):
                raise FloatingPointError(
                    f"NaN/Inf in output of op '{name}'")
    if _TENSOR_STATS_HOOK is not None:
        _TENSOR_STATS_HOOK(name, _outputs(res))
    return res


def _args_info(args, kwargs) -> tuple:
    """The tensor inputs' (shape, dtype) pairs, as the tensors hold them
    (the dump formats them)."""
    T = torch.Tensor
    return tuple((a.shape, a.dtype) for a in (*args, *kwargs.values())
                 if isinstance(a, T))


def hooked(name: str, fn: Callable) -> Callable:
    """``fn`` as the op ``name`` at the choke point: the flight
    recorder's entry, then the AMP cast, the span, the NaN/Inf check and
    the tensor-stats hook around it. The entry holds the op and the
    kernel function's name; an op that raises adds its inputs' shapes
    and dtypes to it (reading them on every dispatch added ~10% to an
    eager engine step on an H100's host)."""
    key = fn.__qualname__

    @functools.wraps(fn)
    def op(*args, **kwargs):
        seq = (_FLIGHT.record(name, None, key)
               if _FLAG_VALUES["flight_recorder"] else None)
        try:
            if _AMP_HOOK is None and _OP_SPAN_HOOK is None \
                    and _TENSOR_STATS_HOOK is None \
                    and not _FLAG_VALUES["check_nan_inf"]:
                return fn(*args, **kwargs)
            return _run_hooked(name, fn, args, kwargs)
        except Exception:
            if seq is not None:
                _FLIGHT.set_args_info(seq, _args_info(args, kwargs))
            raise
    return op


def register_kernel(name: str):
    """Register ``fn`` as the kernel of the registry op ``name`` (the op
    that ``call_op`` builds runs it through :func:`hooked`)."""
    def deco(fn):
        KERNELS[name] = fn
        return fn
    return deco


def signature(name: str) -> inspect.Signature:
    """The op's Python signature: the schema's arguments, then the
    keyword-only ``name=None`` that Paddle's API accepts and ignores."""
    P = inspect.Parameter
    params = [P(n, P.POSITIONAL_OR_KEYWORD, default=d)
              for n, d in SCHEMA[name]]
    params.append(P("name", P.KEYWORD_ONLY, default=None))
    return inspect.Signature(params)


def _make_op(name: str) -> Callable:
    sig, kernel = signature(name), hooked(name, KERNELS[name])

    def op_fn(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        bound.arguments.pop("name", None)
        return kernel(**bound.arguments)

    op_fn.__name__ = op_fn.__qualname__ = name
    op_fn.__signature__ = sig
    op_fn.__doc__ = kernel.__doc__
    return op_fn


def build_ops() -> Dict[str, Callable]:
    """Every op of the table, built once over its registered kernel."""
    if not _OP_FNS:
        from .kernels import (compat_tranche, creation,  # noqa: F401
                              detection, extra_math, extra_misc, extra_nn,
                              graph, linalg_fft, manipulation, math,
                              math_ext, moe, nn, quant, random, rnn, serving,
                              tensor_api_ext, vision_io)  # (register)
        for name in SCHEMA:
            if name not in KERNELS:
                raise RuntimeError(f"op '{name}': no kernel registered")
            _OP_FNS[name] = _make_op(name)
    return dict(_OP_FNS)


def get_op(name: str, /) -> Callable:
    if not _OP_FNS:
        build_ops()
    fn = _OP_FNS.get(name)
    if fn is None:
        raise KeyError(f"unknown op '{name}'")
    return fn


def call_op(name: str, /, *args, **kwargs):
    """The op ``name`` on the arguments; the op name is positional-only,
    so a ``name=`` keyword reaches the op (which drops it)."""
    return get_op(name)(*args, **kwargs)


# -- the Paddle surface: top-level functions, Tensor methods, the inplace
# family and the dunders (the reference's ``build_ops`` :704-800, :886) ----

_PUBLIC: Dict[str, Callable] = {}


def boundary_op(name: str, /) -> Callable:
    """The op ``name`` under the boundary rule: ``Tensor`` arguments give
    ``Tensor`` results, plain tensors plain ones (``core.tensor.
    paddle_call``), also for an op that computes on the host."""
    from ..core.tensor import paddle_call
    op = get_op(name)

    def fn(*args, **kwargs):
        return paddle_call(op, args, kwargs)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = op.__doc__
    fn.__signature__ = op.__signature__
    return fn


def public_op(name: str, /) -> Callable:
    """The op ``name`` on the Paddle surface: ``Tensor`` results always
    (``core.tensor.public``)."""
    fn = _PUBLIC.get(name)
    if fn is None:
        from ..core.tensor import public
        fn = _PUBLIC[name] = public(get_op(name))
    return fn


def _needs_snapshot(target, args, kwargs) -> bool:
    if not torch.is_grad_enabled():
        return False
    return target.requires_grad or any(
        isinstance(a, torch.Tensor) and a.requires_grad
        for a in list(args) + list(kwargs.values()))


def inplace_apply(target: torch.Tensor, compute: Callable, args=(),
                  kwargs=None) -> torch.Tensor:
    """The inplace discipline of every ``*_`` op and ``where_`` (the
    reference's ``inplace_rebind``, :747): a leaf that requires grad may
    not be written while grad is on (its grad would land on the old
    value); the op runs out of place, on a snapshot when a graph is being
    recorded (the op may save its input, which the write would change);
    the result is written into ``target`` (same shape and dtype: a
    ``copy_``, which makes it the graph's new head and bumps its version)
    or rebinds it (``core.tensor._rebind``). Returns ``target``."""
    from ..core.tensor import _Call, _NoSubclassTF, _rebind
    kwargs = kwargs or {}
    with _NoSubclassTF():
        if torch.is_grad_enabled() and target.requires_grad \
                and target.is_leaf:
            raise ValueError("Leaf Tensor that doesn't stop gradient can't "
                             "use inplace strategy")
    c = _Call()
    plain = c.unwrap(target)
    args, kwargs = c.unwrap(args), c.unwrap(kwargs)
    snap = plain.clone() if _needs_snapshot(plain, args, kwargs) else plain
    out = compute(snap, *args, **kwargs)
    if isinstance(out, (tuple, list)):
        out = out[0]
    if out.untyped_storage().data_ptr() == \
            plain.untyped_storage().data_ptr():
        out = out.clone()
    if out.shape == plain.shape and out.dtype == plain.dtype:
        plain.copy_(out)
    else:
        del plain, snap, c
        _rebind(target, out)
    return target


def _inplace_fn(name: str, base: str) -> Callable:
    def fn(x, *args, **kwargs):
        return inplace_apply(x, get_op(base), args, kwargs)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"In-place ``{base}``: writes the result into ``x``."
    return fn


def _as_method(fn: Callable) -> Callable:
    def method(self, *args, **kwargs):
        return fn(self, *args, **kwargs)
    method.__name__ = fn.__name__
    method.__doc__ = fn.__doc__
    return method


_OPERAND = (torch.Tensor, int, float, bool, complex)


def _binop(name: str, reflect: bool = False) -> Callable:
    def dunder(self, other):
        import numpy as np
        if not isinstance(other, _OPERAND + (np.ndarray, np.number)):
            return NotImplemented
        fn = public_op(name)
        return fn(other, self) if reflect else fn(self, other)
    dunder.__name__ = name
    return dunder


def _unop(name: str) -> Callable:
    def dunder(self):
        return public_op(name)(self)
    return dunder


_DUNDERS = {
    "__add__": ("add", False), "__radd__": ("add", True),
    "__sub__": ("subtract", False), "__rsub__": ("subtract", True),
    "__mul__": ("multiply", False), "__rmul__": ("multiply", True),
    "__truediv__": ("divide", False), "__rtruediv__": ("divide", True),
    "__floordiv__": ("floor_divide", False),
    "__rfloordiv__": ("floor_divide", True),
    "__mod__": ("remainder", False), "__rmod__": ("remainder", True),
    "__pow__": ("pow", False), "__rpow__": ("pow", True),
    "__matmul__": ("matmul", False), "__rmatmul__": ("matmul", True),
    "__eq__": ("equal", False), "__ne__": ("not_equal", False),
    "__lt__": ("less_than", False), "__le__": ("less_equal", False),
    "__gt__": ("greater_than", False), "__ge__": ("greater_equal", False),
    "__and__": ("bitwise_and", False), "__rand__": ("bitwise_and", True),
    "__or__": ("bitwise_or", False), "__ror__": ("bitwise_or", True),
    "__xor__": ("bitwise_xor", False), "__rxor__": ("bitwise_xor", True),
}


def build_surface() -> Dict[str, Callable]:
    """Attach the op surface to ``core.tensor.Tensor`` and return the
    top-level functions (every op but the :data:`NAMESPACED` ones, on the
    Paddle surface, and every inplace op): each tensor-first op is a method (Paddle's meaning wins
    over torch's inherited method, but for ``core.tensor.TORCH_OWNED``
    and the names ``Tensor`` defines itself), each inplace op is a method
    and a function, and the arithmetic and comparison dunders run the
    registry's ops."""
    from ..core.tensor import TORCH_OWNED, Tensor
    build_ops()
    own = set(vars(Tensor))
    funcs = {name: public_op(name) for name in SCHEMA}
    for name in SCHEMA:
        if name in NOT_TENSOR_FIRST or name in TORCH_OWNED or name in own:
            continue
        setattr(Tensor, name, _as_method(funcs[name]))
    for name, base in INPLACE.items():
        fn = _inplace_fn(name, base)
        funcs[name] = fn
        setattr(Tensor, name, fn)
    for dunder, (name, reflect) in _DUNDERS.items():
        setattr(Tensor, dunder, _binop(name, reflect))
    for name in NAMESPACED:
        del funcs[name]
    Tensor.__neg__ = _unop("neg")
    Tensor.__abs__ = _unop("abs")
    Tensor.__invert__ = _unop("logical_not")
    Tensor.__hash__ = torch.Tensor.__hash__
    return funcs
