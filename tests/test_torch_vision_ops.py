"""The port's vision tranche of the op table (``ops/kernels/extra_nn.py``:
``ops.yaml`` lines 544-576 and the unified ``batch_norm`` of line 656)
against the JAX package's ops, on the CPU, through
``tests/_torch_op_check.py``: one case or more per op, the same seeded
numpy inputs through both registries' ``call_op``, forward and, for an op
the reference differentiates, the VJP of its floating inputs under a
random cotangent.

Tolerances (float32): 1e-5 absolute and relative (``F32``); the box ops'
outputs in pixels, 1e-4 absolute (``PIX``). Integer outputs (pool
indices, masks) are compared exactly.

Also, one test per convention the port keeps where torch's own function
differs: the interpolation family up, down, fractional, corner-aligned,
channels-last, 1-D and 3-D (``jax.image``'s pixel centres, antialiasing
when shrinking, Keys' cubic at a = -0.5, ``round`` for the output size);
``grid_sample``'s default ``align_corners=True``; ``pool2d`` / ``pool3d``
ceil mode (C5); the flat index convention of ``max_pool*_with_index`` and
``unpool``'s inverse; and the host ops raising under capture.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp
from paddle_tpu_torch.ops.kernels import fused_optimizer as fok
from paddle_tpu_torch.ops.kernels import manipulation as tman

from _torch_op_check import check_op

F32 = dict(atol=1e-5, rtol=1e-5)
PIX = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def normal(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def uniform(lo, hi, *shape, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def boxes(k, size, seed=0, min_wh=2.0):
    """``k`` x1 y1 x2 y2 boxes inside a ``size`` x ``size`` image."""
    r = np.random.RandomState(seed)
    xy = r.uniform(0, size - min_wh - 1, (k, 2))
    wh = r.uniform(min_wh, size / 2, (k, 2))
    b = np.concatenate([xy, np.minimum(xy + wh, size - 1)], 1)
    return b.astype(np.float32)


X = normal(2, 4, 8, 8)
X3 = normal(2, 3, 6, 6, 6)


def _cases():
    c = {}
    grid = uniform(-1.1, 1.1, 2, 5, 6, 2, seed=1)
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border", "reflection"):
            for ac in (True, False):
                c[f"grid_sample_{mode}_{pad}_{ac}"] = (
                    "grid_sample", [X, grid],
                    dict(mode=mode, padding_mode=pad, align_corners=ac), F32)
    theta = normal(2, 2, 3, seed=2)
    for ac in (True, False):
        c[f"affine_grid_{ac}"] = ("affine_grid", [theta],
                                  dict(output_shape=[2, 3, 5, 7],
                                       align_corners=ac), F32)
    c["pixel_unshuffle"] = ("pixel_unshuffle", [X],
                            dict(downscale_factor=2), F32)
    c["pixel_unshuffle_nhwc"] = ("pixel_unshuffle", [normal(2, 8, 6, 3)],
                                 dict(downscale_factor=2,
                                      data_format="NHWC"), F32)
    c["channel_shuffle"] = ("channel_shuffle", [X], dict(groups=2), F32)
    c["channel_shuffle_nhwc"] = ("channel_shuffle", [normal(2, 5, 5, 6)],
                                 dict(groups=3, data_format="NHWC"), F32)
    c["temporal_shift"] = ("temporal_shift", [normal(6, 8, 3, 3)],
                           dict(seg_num=3, shift_ratio=0.25), F32)
    c["maxout"] = ("maxout", [normal(2, 6, 4, 4)], dict(groups=3), F32)
    c["maxout_last"] = ("maxout", [normal(2, 4, 4, 6)],
                        dict(groups=2, axis=-1), F32)
    for mode in ("constant", "reflect", "replicate", "circular"):
        c[f"pad3d_{mode}"] = ("pad3d", [X3],
                              dict(paddings=[1, 2, 0, 1, 2, 1], mode=mode,
                                   value=0.5), F32)
    c["pad3d_ndhwc"] = ("pad3d", [normal(1, 4, 4, 4, 2)],
                        dict(paddings=[1, 1, 2, 0, 0, 1],
                             data_format="NDHWC"), F32)
    for op in ("max", "avg"):
        c[f"pool2d_{op}"] = ("pool2d", [X],
                             dict(kernel_size=[3, 3], strides=[2, 2],
                                  paddings=[1, 1], pooling_type=op), F32)
        c[f"pool2d_{op}_ceil"] = ("pool2d", [X],
                                  dict(kernel_size=[3, 3], strides=[2, 2],
                                       paddings=[0, 0], pooling_type=op,
                                       ceil_mode=True), F32)
        c[f"pool2d_{op}_adaptive"] = ("pool2d", [X],
                                      dict(kernel_size=[2, 4],
                                           pooling_type=op, adaptive=True),
                                      F32)
        c[f"pool2d_{op}_global"] = ("pool2d", [X],
                                    dict(kernel_size=[1, 1], pooling_type=op,
                                         global_pooling=True), F32)
        c[f"pool3d_{op}"] = ("pool3d", [X3],
                             dict(kernel_size=[2, 3, 2], strides=[2, 1, 2],
                                  paddings=[1, 1, 0], pooling_type=op), F32)
        c[f"pool3d_{op}_ceil"] = ("pool3d", [X3],
                                  dict(kernel_size=[3, 3, 3],
                                       strides=[2, 2, 2], pooling_type=op,
                                       ceil_mode=True), F32)
    c["pool2d_avg_incl"] = ("pool2d", [X],
                            dict(kernel_size=[3, 3], strides=[2, 2],
                                 paddings=[1, 1], pooling_type="avg",
                                 exclusive=False), F32)
    c["pool2d_nhwc"] = ("pool2d", [normal(2, 6, 6, 3)],
                        dict(kernel_size=[2, 2], pooling_type="avg",
                             data_format="NHWC"), F32)
    c["max_pool2d_with_index"] = ("max_pool2d_with_index", [X],
                                  dict(kernel_size=[3, 3], strides=[2, 2],
                                       paddings=[1, 1]), F32)
    c["max_pool2d_with_index_nopad"] = ("max_pool2d_with_index", [X],
                                        dict(kernel_size=[2, 2]), F32)
    c["max_pool3d_with_index"] = ("max_pool3d_with_index", [X3],
                                  dict(kernel_size=[2, 2, 2],
                                       strides=[2, 2, 2]), F32)
    # unpool: the values and indices of a 2 x 2 max pool
    pooled = normal(2, 3, 4, 4, seed=3)
    idx2 = _pool_indices((2, 3, 4, 4), (8, 8), seed=4)
    c["unpool"] = ("unpool", [pooled, idx2],
                   dict(kernel_size=[2, 2], strides=[2, 2],
                        output_size=[8, 8]), F32)
    pooled3 = normal(1, 2, 2, 2, 2, seed=5)
    idx3 = _pool_indices((1, 2, 2, 2, 2), (4, 4, 4), seed=6)
    c["unpool3d"] = ("unpool3d", [pooled3, idx3],
                     dict(kernel_size=[2, 2, 2], strides=[2, 2, 2],
                          output_size=[4, 4, 4]), F32)
    c["fold"] = ("fold", [normal(2, 3 * 4, 9, seed=7)],
                 dict(output_sizes=[4, 4], kernel_sizes=[2, 2]), F32)
    c["fold_strided"] = ("fold", [normal(1, 2 * 9, 16, seed=8)],
                         dict(output_sizes=[7, 7], kernel_sizes=[3, 3],
                              strides=[2, 2], paddings=[1, 1]), F32)
    c["fractional_max_pool2d"] = ("fractional_max_pool2d", [normal(2, 3, 9, 9)],
                                  dict(output_size=[4, 4], random_u=0.3), F32)
    c["fractional_max_pool2d_mask"] = (
        "fractional_max_pool2d", [normal(1, 2, 10, 7)],
        dict(output_size=[3, 4], kernel_size=[3, 2], random_u=0.7,
             return_mask=True), F32)
    w3 = normal(4, 3, 2, 3, 3, seed=9, scale=0.3)
    c["conv3d"] = ("conv3d", [X3, w3],
                   dict(stride=[1, 2, 1], padding=[1, 1, 0]), F32)
    c["conv3d_groups"] = ("conv3d", [normal(1, 4, 5, 5, 5),
                                     normal(6, 2, 3, 3, 3, seed=10)],
                          dict(groups=2, dilation=[1, 2, 1]), F32)
    c["conv3d_same"] = ("conv3d", [X3, w3],
                        dict(stride=[2, 2, 2], padding="SAME"), F32)
    c["conv3d_ndhwc"] = ("conv3d", [normal(1, 5, 5, 5, 3),
                                    normal(2, 3, 3, 3, 3, seed=11)],
                         dict(data_format="NDHWC"), F32)
    c["conv3d_transpose"] = ("conv3d_transpose",
                             [normal(1, 4, 3, 3, 3),
                              normal(4, 3, 2, 3, 3, seed=12, scale=0.3)],
                             dict(stride=[2, 1, 2], padding=[0, 1, 1],
                                  output_padding=[1, 0, 1]), F32)
    c["conv3d_transpose_groups"] = ("conv3d_transpose",
                                    [normal(1, 4, 3, 3, 3),
                                     normal(4, 2, 2, 2, 2, seed=13)],
                                    dict(stride=[2, 2, 2], groups=2,
                                         dilation=[1, 2, 1]), F32)
    c.update(_interp_cases())
    c["spectral_norm"] = ("spectral_norm",
                          [normal(6, 4, 3, seed=14), normal(6, seed=15),
                           normal(12, seed=16)],
                          dict(dim=0, power_iters=2), F32)
    c["spectral_norm_dim1"] = ("spectral_norm",
                               [normal(5, 4, 3, seed=14), normal(4, seed=15),
                                normal(15, seed=16)],
                               dict(dim=1, power_iters=1), F32)
    seg = np.array([0, 0, 1, 3, 3, 3, 2], np.int32)
    for pt in ("SUM", "MEAN", "MAX", "MIN"):
        c[f"segment_pool_{pt}"] = ("segment_pool", [normal(7, 3, seed=17),
                                                    seg],
                                   dict(pooltype=pt), F32)
    c["overlap_add"] = ("overlap_add", [normal(2, 5, 8, seed=18)],
                        dict(hop_length=3), F32)
    c["overlap_add_axis0"] = ("overlap_add", [normal(8, 5, 2, seed=19)],
                              dict(hop_length=4, axis=0), F32)
    prior = boxes(6, 32, seed=20)
    pvar = uniform(0.1, 0.3, 6, 4, seed=21)
    c["box_coder_encode"] = ("box_coder", [prior, pvar, boxes(4, 32, seed=22)],
                             dict(box_normalized=False), PIX)
    c["box_coder_encode_novar"] = ("box_coder",
                                   [prior / 32, None, boxes(3, 32, seed=23) / 32],
                                   {}, PIX)
    for axis in (0, 1):
        n = (6, 6) if axis == 0 else (5, 6)
        c[f"box_coder_decode_axis{axis}"] = (
            "box_coder", [prior, pvar, normal(*n, 4, seed=24, scale=0.3)],
            dict(code_type="decode_center_size", box_normalized=False,
                 axis=axis), PIX)
    feat = normal(2, 3, 16, 16, seed=25)
    rb = boxes(5, 60, seed=26)
    bn = np.array([2, 3], np.int32)
    for aligned in (True, False):
        c[f"roi_align_{aligned}"] = ("roi_align", [feat, rb, bn],
                                     dict(pooled_height=3, pooled_width=2,
                                          spatial_scale=0.25,
                                          sampling_ratio=2, aligned=aligned),
                                     F32)
    c["roi_align_default_ratio"] = ("roi_align", [feat, rb[:2]],
                                    dict(pooled_height=2, pooled_width=2,
                                         spatial_scale=0.25), F32)
    c["roi_pool"] = ("roi_pool", [feat, rb, bn],
                     dict(pooled_height=3, pooled_width=3,
                          spatial_scale=0.25), F32)
    c["roi_pool_one_image"] = ("roi_pool", [feat[:1], rb[:3]],
                               dict(pooled_height=2, pooled_width=4,
                                    spatial_scale=0.25), F32)
    c["prior_box"] = ("prior_box", [normal(1, 2, 4, 5), normal(1, 3, 32, 40)],
                      dict(min_sizes=[8.0, 16.0], max_sizes=[12.0, 24.0],
                           aspect_ratios=[2.0, 3.0], flip=True, clip=True),
                      F32)
    c["prior_box_steps"] = ("prior_box",
                            [normal(1, 2, 3, 3), normal(1, 3, 30, 30)],
                            dict(min_sizes=[10.0], aspect_ratios=[1.0, 0.5],
                                 steps=[8.0, 8.0], offset=0.25), F32)
    mean, var = normal(4, seed=27), uniform(0.5, 2.0, 4, seed=28)
    scale, bias = normal(4, seed=29), normal(4, seed=30)
    for mode, kw in (("train", {}), ("test", dict(is_test=True)),
                     ("global", dict(use_global_stats=True))):
        c[f"batch_norm_{mode}"] = ("batch_norm", [X, mean, var, scale, bias],
                                   dict(momentum=0.8, **kw), F32)
    c["batch_norm_nhwc"] = ("batch_norm", [normal(2, 3, 3, 4), mean, var,
                                           scale, bias],
                            dict(data_format="NHWC"), F32)
    return c


def _pool_indices(shape, out_sp, seed):
    """Distinct flat spatial indices per (n, c) row (a pool's indices)."""
    r = np.random.RandomState(seed)
    n, c = shape[:2]
    k = int(np.prod(shape[2:]))
    total = int(np.prod(out_sp))
    rows = [r.permutation(total)[:k] for _ in range(n * c)]
    return np.stack(rows).reshape(shape).astype(np.int32)


INTERP = {
    "up2": dict(scale_factor=2.0),
    "down": dict(size=[4, 3]),
    "fractional": dict(scale_factor=1.5),
    "fractional_down": dict(scale_factor=0.6),
    "mixed": dict(size=[11, 5]),
    "corners_up": dict(size=[13, 11], align_corners=True),
    "corners_down": dict(size=[5, 3], align_corners=True),
}


def _interp_cases():
    c = {}
    x = normal(2, 3, 7, 6, seed=31)
    for op in ("bilinear_interp", "bicubic_interp", "nearest_interp"):
        for tag, kw in INTERP.items():
            c[f"{op}_{tag}"] = (op, [x], kw, F32)
        c[f"{op}_nhwc"] = (op, [normal(1, 5, 4, 3, seed=32)],
                           dict(size=[8, 7], data_format="NHWC"), F32)
    x1 = normal(2, 3, 9, seed=33)
    for tag, kw in (("up", dict(scale_factor=2.5)), ("down", dict(size=[4])),
                    ("corners", dict(size=[13], align_corners=True))):
        c[f"linear_interp_{tag}"] = ("linear_interp", [x1], kw, F32)
    c["linear_interp_nwc"] = ("linear_interp", [normal(2, 9, 3, seed=34)],
                              dict(size=[5], data_format="NWC"), F32)
    x3 = normal(1, 2, 4, 5, 6, seed=35)
    for tag, kw in (("up", dict(scale_factor=2.0)),
                    ("down", dict(size=[3, 2, 4])),
                    ("corners", dict(size=[6, 7, 3], align_corners=True)),
                    ("ndhwc", dict(size=[5, 5, 5], data_format="NDHWC"))):
        c[f"trilinear_interp_{tag}"] = ("trilinear_interp", [x3], kw, F32)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name, args, kw, tol = CASES[case]
    check_op(name, args, kw, **tol)


def test_every_vision_op_has_a_case():
    """Every op the port's ``extra_nn.py`` registers has a case here
    (``viterbi_decode`` has its cases in ``test_torch_text.py``)."""
    from paddle_tpu_torch.ops.kernels import extra_nn
    owned = {n for n, k in tdisp.KERNELS.items()
             if k.__module__ == extra_nn.__name__} - {"viterbi_decode"}
    assert len(owned) == 30
    assert owned - {v[0] for v in CASES.values()} == set()


# -- the conventions torch's own functions do not share -----------------------

def test_interp_follows_jax_image_not_torch_defaults():
    """Shrinking antialiases, bicubic is Keys a = -0.5, nearest samples
    pixel centres and sizes round: torch's plain ``F.interpolate`` gives
    other numbers on each (so the port cannot be it)."""
    x = normal(1, 1, 9, 9, seed=40)
    t = torch.from_numpy(x)
    down = tdisp.call_op("bilinear_interp", t, size=[4, 4])
    plain = F.interpolate(t, size=(4, 4), mode="bilinear",
                          align_corners=False)
    assert float((down - plain).abs().max()) > 1e-2
    up = tdisp.call_op("bicubic_interp", t, scale_factor=2.0)
    keys75 = F.interpolate(t, scale_factor=2.0, mode="bicubic",
                           align_corners=False)
    assert float((up - keys75).abs().max()) > 1e-2
    near = tdisp.call_op("nearest_interp", t, size=[5, 5])
    exact = F.interpolate(t, size=(5, 5), mode="nearest-exact")
    legacy = F.interpolate(t, size=(5, 5), mode="nearest")
    assert torch.equal(near, exact) and not torch.equal(near, legacy)
    # the size is Python's round (half to even): 5 * 0.5 -> 2, and
    # 7 * 0.5 -> 4 where floor would give 3
    assert tuple(tdisp.call_op("bilinear_interp", torch.zeros(1, 1, 5, 5),
                               scale_factor=0.5).shape[2:]) == (2, 2)
    assert tuple(tdisp.call_op("bilinear_interp", torch.zeros(1, 1, 7, 7),
                               scale_factor=0.5).shape[2:]) == (4, 4)


def test_grid_sample_defaults_to_align_corners():
    """The registry op's default is ``align_corners=True`` (torch's
    ``F.grid_sample`` defaults to False): the default call equals the
    explicit True call and ``F.grid_sample(align_corners=True)``."""
    x = torch.from_numpy(normal(1, 2, 5, 6))
    g = torch.from_numpy(uniform(-0.9, 0.9, 1, 3, 4, 2, seed=1))
    got = tdisp.call_op("grid_sample", x, g)
    assert torch.equal(got, tdisp.call_op("grid_sample", x, g,
                                          align_corners=True))
    torch.testing.assert_close(got, F.grid_sample(x, g, align_corners=True),
                               atol=1e-6, rtol=1e-6)
    assert float((got - F.grid_sample(x, g, align_corners=False))
                 .abs().max()) > 1e-2


@pytest.mark.parametrize("op,exclusive", [("max", True), ("avg", True),
                                          ("avg", False)])
def test_pool_ceil_mode_pads_the_high_side(op, exclusive):
    """C5: ceil mode keeps the last partial window; a non-exclusive
    average divides it by the whole k x k (torch's ``count_include_pad``
    would divide by the clipped window), an exclusive one by its
    elements."""
    x = torch.from_numpy(normal(1, 1, 6, 6, seed=41))
    out = tdisp.call_op("pool2d", x, kernel_size=[3, 3], strides=[2, 2],
                        pooling_type=op, ceil_mode=True, exclusive=exclusive)
    assert tuple(out.shape) == (1, 1, 3, 3)
    corner = x[0, 0, 4:, 4:]
    want = corner.max() if op == "max" else \
        corner.sum() / (corner.numel() if exclusive else 9)
    torch.testing.assert_close(out[0, 0, 2, 2], want)


def test_pool_with_index_flat_index_and_unpool_inverse():
    """Indices are flat over each (n, c) plane (row-major ``h * W + w``)
    of the unpadded input, first max in a tie; ``unpool`` puts each value
    back there."""
    x = torch.from_numpy(normal(2, 3, 6, 6, seed=42))
    out, idx = tdisp.call_op("max_pool2d_with_index", x, kernel_size=[2, 2])
    flat = x.reshape(2, 3, 36)
    torch.testing.assert_close(torch.gather(flat, 2, idx.reshape(2, 3, -1))
                               .reshape(out.shape), out)
    tie = torch.zeros(1, 1, 2, 2)
    assert int(tdisp.call_op("max_pool2d_with_index", tie,
                             kernel_size=[2, 2])[1]) == 0
    back = tdisp.call_op("unpool", out, idx, kernel_size=[2, 2],
                         strides=[2, 2], output_size=[6, 6])
    assert torch.equal(back.reshape(2, 3, 36).gather(2, idx.reshape(2, 3, -1)),
                       out.reshape(2, 3, -1))
    assert int((back != 0).sum()) == out.numel()


@pytest.mark.parametrize("name,args,kw", [
    ("segment_pool", [torch.ones(3, 2), torch.tensor([0, 0, 1])], {}),
    ("roi_align", [torch.ones(1, 1, 4, 4), torch.tensor([[0., 0, 2, 2]])],
     {}),
    ("roi_pool", [torch.ones(1, 1, 4, 4), torch.tensor([[0., 0, 2, 2]])], {}),
    ("prior_box", [torch.ones(1, 1, 2, 2), torch.ones(1, 3, 8, 8)],
     dict(min_sizes=[4.0]))])
def test_host_ops_raise_under_capture(name, args, kw):
    tdisp.call_op(name, *args, **kw)          # eagerly: fine
    with fok.deferred_tables(()):             # a capture in progress
        with pytest.raises(tman.DataDependentShapeError, match=name):
            tdisp.call_op(name, *args, **kw)
