"""The port's detection tranche of the op table (``ops/kernels/
detection.py``: ``ops.yaml`` lines 660-668 and ``nms`` of line 542)
against the JAX package's ops, on the CPU, through
``tests/_torch_op_check.py``: the same seeded numpy inputs through both
registries' ``call_op``, forward and, for an op the reference
differentiates, the VJP of its floating inputs under a random cotangent.

Tolerances: float32 outputs 1e-5 absolute and relative; boxes in pixels
1e-4 absolute. Selection outputs (kept indices, labels, counts) exactly.

Also: ``yolo_loss`` where two gts fall in one cell (the later one wins
the objectness mark, as in the reference's loop), its backward free of
atomic adds (run to run equal bits), and captured; ``nms`` ties broken
as the reference's unstable ``argsort`` breaks them and
``vision.ops.nms``'s stable ones; and the host ops raising under capture.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp
from paddle_tpu_torch.ops.kernels import fused_optimizer as fok
from paddle_tpu_torch.ops.kernels import manipulation as tman

from _torch_op_check import check_op, run_ref

F32 = dict(atol=1e-5, rtol=1e-5)
PIX = dict(atol=1e-4, rtol=1e-5)
ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
           198, 373, 326]


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


def xyxy(n, m, size, seed=0):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, size * 0.7, (n, m, 2))
    wh = r.uniform(size * 0.05, size * 0.3, (n, m, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def gt_boxes(n, b, seed=0, empty=2):
    """Normalized (cx, cy, w, h) gts; the last ``empty`` of each image
    zero (padding rows)."""
    r = np.random.RandomState(seed)
    g = np.concatenate([r.uniform(0.1, 0.9, (n, b, 2)),
                        r.uniform(0.02, 0.6, (n, b, 2))], -1)
    g[:, b - empty:] = 0
    return g.astype(np.float32)


def _cases():
    c = {}
    C = 3
    for i, (mask, ds) in enumerate((([6, 7, 8], 32), ([0, 1, 2], 8))):
        x = normal(2, 3 * (5 + C), 4, 4, seed=1 + i)
        c[f"yolo_box_{ds}"] = ("yolo_box", [x, np.array([[128, 96], [100, 140]],
                                                         np.int32)],
                               dict(anchors=[ANCHORS[2 * m + d] for m in mask
                                             for d in (0, 1)],
                                    class_num=C, conf_thresh=0.3,
                                    downsample_ratio=ds), PIX)
    c["yolo_box_noclip_scale"] = ("yolo_box", [normal(1, 2 * (5 + C), 3, 5,
                                                      seed=3),
                                               np.array([[90, 150]], np.int32)],
                                  dict(anchors=ANCHORS[:4], class_num=C,
                                       clip_bbox=False, scale_x_y=1.05), PIX)
    c["yolo_box_iou_aware"] = ("yolo_box", [normal(1, 2 * (6 + C), 3, 3,
                                                   seed=4),
                                            np.array([[96, 96]], np.int32)],
                               dict(anchors=ANCHORS[:4], class_num=C,
                                    iou_aware=True, iou_aware_factor=0.4),
                               PIX)
    gt = gt_boxes(2, 6, seed=5)
    lab = np.random.RandomState(6).randint(0, C, (2, 6)).astype(np.int32)
    score = uniform(0.5, 1.0, 2, 6, seed=7)
    for i, (mask, ds, hw) in enumerate((([6, 7, 8], 32, 3),
                                        ([3, 4, 5], 16, 6),
                                        ([0, 1, 2], 8, 12))):
        x = normal(2, 3 * (5 + C), hw, hw, seed=8 + i)
        kw = dict(anchors=ANCHORS, anchor_mask=mask, class_num=C,
                  ignore_thresh=0.5, downsample_ratio=ds)
        c[f"yolo_loss_{ds}"] = ("yolo_loss", [x, gt, lab, score], kw, F32)
    x = normal(2, 3 * (5 + C), 4, 4, seed=12)
    c["yolo_loss_noscore_nosmooth"] = (
        "yolo_loss", [x, gt, lab, None],
        dict(anchors=ANCHORS, anchor_mask=[6, 7, 8], class_num=C,
             use_label_smooth=False, scale_x_y=1.1, downsample_ratio=32),
        F32)
    off = normal(1, 2 * 9, 5, 5, seed=13, scale=0.7)
    msk = uniform(0, 1, 1, 9, 5, 5, seed=14)
    c["deformable_conv_v2"] = ("deformable_conv",
                               [normal(1, 4, 5, 5, seed=15), off,
                                normal(6, 4, 3, 3, seed=16, scale=0.3), msk],
                               dict(paddings=[1, 1]), F32)
    c["deformable_conv_v1_groups"] = (
        "deformable_conv", [normal(2, 4, 6, 6, seed=17),
                            normal(2, 2 * 2 * 4, 3, 3, seed=18, scale=0.5),
                            normal(4, 2, 2, 2, seed=19, scale=0.3), None],
        dict(strides=[2, 2], deformable_groups=2, groups=2), F32)
    feat = normal(2, 2 * 9, 12, 12, seed=20)
    rb = xyxy(1, 5, 40, seed=21)[0]
    c["psroi_pool"] = ("psroi_pool", [feat, rb, np.array([2, 3], np.int32)],
                       dict(pooled_height=3, pooled_width=3,
                            output_channels=2, spatial_scale=0.25), F32)
    c["psroi_pool_one_image"] = ("psroi_pool", [feat[:1], rb[:2]],
                                 dict(pooled_height=3, pooled_width=3,
                                      output_channels=2, spatial_scale=0.3),
                                 F32)
    bb = xyxy(2, 30, 1.0, seed=22)
    sc = uniform(0, 1, 2, 4, 30, seed=23)
    c["multiclass_nms3"] = ("multiclass_nms3", [bb, sc],
                            dict(score_threshold=0.3, nms_top_k=20,
                                 keep_top_k=15, nms_threshold=0.4), F32)
    c["multiclass_nms3_pixels_eta"] = (
        "multiclass_nms3", [xyxy(1, 25, 100, seed=24),
                            uniform(0, 1, 1, 3, 25, seed=25)],
        dict(score_threshold=0.1, nms_threshold=0.6, normalized=False,
             nms_eta=0.9, background_label=-1), F32)
    for g in (False, True):
        c[f"matrix_nms_{g}"] = ("matrix_nms", [bb, sc],
                                dict(score_threshold=0.2, post_threshold=0.1,
                                     nms_top_k=25, keep_top_k=30,
                                     use_gaussian=g), F32)
    A, H, W = 3, 4, 5
    anchors = np.concatenate([uniform(0, 40, H, W, A, 2, seed=26),
                              uniform(45, 90, H, W, A, 2, seed=27)], -1)
    c["generate_proposals"] = (
        "generate_proposals",
        [uniform(0, 1, 2, A, H, W, seed=28), normal(2, 4 * A, H, W, seed=29,
                                                    scale=0.3),
         np.array([[80, 96], [100, 90]], np.float32), anchors,
         np.full((H, W, A, 4), 0.5, np.float32)],
        dict(pre_nms_top_n=40, post_nms_top_n=12, nms_thresh=0.6,
             min_size=2.0), PIX)
    rois = np.concatenate([xyxy(1, 12, 400, seed=30)[0],
                           xyxy(1, 4, 40, seed=31)[0]])
    c["distribute_fpn_proposals"] = ("distribute_fpn_proposals",
                                     [rois, np.array([9, 7], np.int32)],
                                     dict(refer_scale=100), F32)
    c["distribute_fpn_proposals_one"] = ("distribute_fpn_proposals",
                                         [rois[:6]],
                                         dict(min_level=3, max_level=4,
                                              pixel_offset=False), F32)
    b = xyxy(1, 40, 50, seed=32)[0]
    c["nms"] = ("nms", [b, uniform(0, 1, 40, seed=33)],
                dict(iou_threshold=0.4), F32)
    c["nms_no_scores"] = ("nms", [b, None], dict(iou_threshold=0.2), F32)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name, args, kw, tol = CASES[case]
    check_op(name, args, kw, **tol)


def test_every_detection_op_has_a_case():
    from paddle_tpu_torch.ops.kernels import detection
    owned = {n for n, k in tdisp.KERNELS.items()
             if k.__module__ == detection.__name__}
    assert len(owned) == 9
    assert owned - {v[0] for v in CASES.values()} == set()


def _yolo_args(seed=0):
    x = normal(2, 3 * 7, 4, 4, seed=seed)
    # gts 0 and 1 of image 0 fall in one cell with one best anchor (same
    # centre cell, same shape), with different mixup scores
    gt = np.array([[[0.30, 0.30, 0.9, 0.7], [0.32, 0.33, 0.9, 0.7],
                    [0.8, 0.7, 0.2, 0.1], [0, 0, 0, 0]],
                   [[0.6, 0.4, 0.3, 0.3], [0.1, 0.9, 0.05, 0.1],
                    [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    lab = np.array([[0, 1, 1, 0], [1, 0, 0, 0]], np.int32)
    score = np.array([[0.9, 0.6, 1.0, 1.0], [1.0, 0.7, 1.0, 1.0]],
                     np.float32)
    kw = dict(anchors=ANCHORS, anchor_mask=[6, 7, 8], class_num=2,
              downsample_ratio=32)
    return x, gt, lab, score, kw


def test_yolo_loss_later_gt_wins_a_shared_cell():
    """Two gts in one cell and anchor: the cell's objectness mark is the
    later gt's score (0.6, not 0.9), in both packages."""
    x, gt, lab, score, kw = _yolo_args()
    out = check_op("yolo_loss", [x, gt, lab, score], kw, **F32)
    obj, match = out[1], out[2]
    assert int(match[0, 0]) == int(match[0, 1]) >= 0
    m = int(match[0, 0])
    gi, gj = int(0.30 * 4), int(0.30 * 4)
    assert float(obj[0, m, gj, gi]) == pytest.approx(0.6)
    ref = run_ref("yolo_loss", [x, gt, lab, score], kw, False)[0]
    assert float(ref[1].numpy()[0, m, gj, gi]) == pytest.approx(0.6)


def test_yolo_loss_backward_is_deterministic_and_capturable():
    """The grads of the logits come out bit for bit equal run to run (no
    atomic adds: the positive cells are read by a product), and the loss
    runs while a step is being captured (no host read)."""
    x, gt, lab, score, kw = _yolo_args(seed=1)

    def grads():
        t = torch.from_numpy(x.copy()).requires_grad_()
        loss = tdisp.call_op("yolo_loss", t, torch.from_numpy(gt),
                             torch.from_numpy(lab), torch.from_numpy(score),
                             **kw)[0].sum()
        loss.backward()
        return loss.detach(), t.grad
    (l1, g1), (l2, g2) = grads(), grads()
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    with fok.deferred_tables(()):
        grads()


def test_nms_ties_break_as_the_references():
    """Equal scores: the ``nms`` op keeps the order of numpy's default
    ``argsort`` (the reference's), whatever it is on these ties."""
    r = np.random.RandomState(3)
    b = np.concatenate([r.uniform(0, 30, (24, 2)),
                        r.uniform(0, 30, (24, 2)) + 31], 1).astype(np.float32)
    s = np.repeat(np.float32([0.9, 0.5, 0.2]), 8)
    got = tdisp.call_op("nms", torch.from_numpy(b), torch.from_numpy(s),
                        iou_threshold=0.3)
    ref = run_ref("nms", [b, s], dict(iou_threshold=0.3), False)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))


@pytest.mark.parametrize("name", ["multiclass_nms3", "matrix_nms", "nms",
                                  "psroi_pool", "distribute_fpn_proposals"])
def test_host_ops_raise_under_capture(name):
    name_, args, kw, _ = next(v for v in CASES.values() if v[0] == name)
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]
    tdisp.call_op(name, *args, **kw)
    with fok.deferred_tables(()):
        with pytest.raises(tman.DataDependentShapeError, match=name):
            tdisp.call_op(name, *args, **kw)
