"""``paddle.vision.ops`` (counterpart of ``paddle_tpu/vision/ops.py``):
``box_area`` and ``box_iou`` as tensor arithmetic, ``nms`` on the host
(its output length depends on the data) with a stable sort by score, per
category when ``category_idxs`` is given, and the IO ops ``read_file`` /
``decode_jpeg`` of the registry. ``Tensor`` in, ``Tensor`` out.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import paddle_call, to_tensor
from ..ops.dispatcher import public_op

__all__ = ["box_area", "box_iou", "nms", "deform_conv2d", "read_file",
           "decode_jpeg"]


def read_file(filename, name=None):
    """The file's bytes as a 1-D uint8 ``Tensor``."""
    return public_op("read_file")(filename=str(filename))


def decode_jpeg(x, mode="unchanged", name=None):
    """A JPEG byte stream -> CHW uint8 ``Tensor`` (decoded by PIL on the
    host)."""
    return public_op("decode_jpeg")(x, mode=mode)


def _t(x):
    """A ``Tensor`` (host data goes to ``set_device``'s device)."""
    return x if isinstance(x, torch.Tensor) else to_tensor(np.asarray(x))


def _box_area(boxes):
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def box_area(boxes):
    """boxes ``[N, 4]`` (x1, y1, x2, y2) -> ``[N]``."""
    return paddle_call(_box_area, (_t(boxes),), {})


def _box_iou(b1, b2):
    area1, area2 = _box_area(b1), _box_area(b2)
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter).clamp(min=1e-10)


def box_iou(boxes1, boxes2):
    """Pairwise IoU: ``[N, 4]`` x ``[M, 4]`` -> ``[N, M]``."""
    return paddle_call(_box_iou, (_t(boxes1), _t(boxes2)), {})


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
         categories=None, top_k=None):
    boxes_np = _host(boxes)
    n = boxes_np.shape[0]
    scores_np = (np.arange(n - 1, -1, -1, dtype=np.float32)
                 if scores is None else _host(scores))
    if category_idxs is not None:
        cat = _host(category_idxs)
        keep_all = []
        cats = categories if categories is not None else np.unique(cat)
        for c in cats:
            idx = np.nonzero(cat == c)[0]
            if idx.size == 0:
                continue
            kept = _nms_single(boxes_np[idx], scores_np[idx], iou_threshold)
            keep_all.append(idx[kept])
        keep = np.concatenate(keep_all) if keep_all else np.empty(0, np.int64)
        keep = keep[np.argsort(-scores_np[keep], kind="stable")]
    else:
        keep = _nms_single(boxes_np, scores_np, iou_threshold)
    if top_k is not None:
        keep = keep[:top_k]
    dev = boxes.device if isinstance(boxes, torch.Tensor) else "cpu"
    return torch.from_numpy(keep.astype(np.int64)).to(dev)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS: the kept indices (int64), highest score first, ties in
    index order (a stable sort); per category when ``category_idxs`` is
    given, then merged by score."""
    return paddle_call(_nms, (_t(boxes), iou_threshold, scores,
                              category_idxs, categories, top_k), {})


def _nms_single(boxes, scores, thresh):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        inter = w * h
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-10)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, dtype=np.int64)


def deform_conv2d(*args, **kwargs):
    """Not provided, as in the reference: use the ``deformable_conv`` op."""
    raise NotImplementedError(
        "deform_conv2d is not provided; call the deformable_conv op "
        "(paddle.deformable_conv) instead")
