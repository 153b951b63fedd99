"""The detection tranche of the op table: ``yolo_box``, ``yolo_loss``,
``deformable_conv``, ``psroi_pool``, ``multiclass_nms3``, ``matrix_nms``,
``generate_proposals``, ``distribute_fpn_proposals`` and ``nms``.

Counterparts of ``paddle_tpu/ops/kernels/detection.py`` (``ops.yaml``
lines 660-668) and of ``extra_math.py:402`` (``nms``, ``ops.yaml:542``).
The dense ops are torch composites of the reference's arithmetic:

- ``yolo_loss`` writes the positive cells of its objectness mask one gt
  after another, in gt order, so that a later gt in the same cell wins as
  in the reference's loop; each write is an out-of-place ``index_put``
  over distinct images. The logits at the positive cells are read by a
  one-hot product (``bmm``), whose backward is a product too: no atomic
  adds, so a captured step equals its eager run bit for bit. Nothing is
  read on the host, so the loss is capturable.
- ``deformable_conv`` is a bilinear gather of the offset taps and one
  product with the filter.

The selection ops, whose output sizes depend on the data (the NMS family,
proposals, FPN levels, ``psroi_pool``'s per-image boxes), run the
reference's numpy code on the host in the same order, with the same sorts
(``nms`` sorts with numpy's default, unstable ``argsort``, as the
reference does; the others stably) and so the same ties. They raise
:class:`DataDependentShapeError` while a step is being captured. Index
outputs are int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dispatcher import register_kernel
from .manipulation import _not_captured


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _dev(t):
    return t.device if isinstance(t, torch.Tensor) else torch.device("cpu")


_CONSTS: dict = {}


def _const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor on ``device``, made once: a captured step
    reads the copy its eager probe made (a host copy cannot be
    captured)."""
    key = (tuple(values), str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(list(values), dtype=dtype).to(device)
    return t


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# yolo_box
# ---------------------------------------------------------------------------

@register_kernel("yolo_box")
def _yolo_box(x, img_size, anchors=(), class_num=1, conf_thresh=0.01,
              downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
              iou_aware=False, iou_aware_factor=0.5):
    """x ``[n, an*(5+C)(+an), h, w]``, img_size ``[n, 2]`` (h, w) ->
    boxes ``[n, an*h*w, 4]`` (x1 y1 x2 y2 in image pixels) and scores
    ``[n, an*h*w, C]``; predictions under ``conf_thresh`` are zeros."""
    anchors = [int(a) for a in anchors]
    an_num = len(anchors) // 2
    n, _, h, w = x.shape
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    in_h, in_w = downsample_ratio * h, downsample_ratio * w
    dev = x.device
    if iou_aware:
        iou_pred = torch.sigmoid(x[:, :an_num].float())
        x = x[:, an_num:]
    x = x.reshape(n, an_num, 5 + class_num, h, w).float()
    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(h, w)
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .expand(h, w)
    aw = _const(anchors[0::2], dev)[None, :, None, None]
    ah = _const(anchors[1::2], dev)[None, :, None, None]
    cx = (gx + torch.sigmoid(x[:, :, 0]) * scale + bias) * img_w / w
    cy = (gy + torch.sigmoid(x[:, :, 1]) * scale + bias) * img_h / h
    bw = torch.exp(x[:, :, 2]) * aw * img_w / in_w
    bh = torch.exp(x[:, :, 3]) * ah * img_h / in_h
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        x1 = x1.clamp(min=0)
        y1 = y1.clamp(min=0)
        x2 = torch.minimum(x2, img_w - 1)
        y2 = torch.minimum(y2, img_h - 1)
    conf = torch.sigmoid(x[:, :, 4])
    if iou_aware:
        conf = conf ** (1.0 - iou_aware_factor) * \
            iou_pred ** float(iou_aware_factor)
    keep = conf >= conf_thresh
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(keep[..., None], boxes, 0.0)
    cls = torch.sigmoid(x[:, :, 5:])                     # [n, an, C, h, w]
    scores = cls.movedim(2, -1) * conf[..., None]
    scores = torch.where(keep[..., None], scores, 0.0)
    return (boxes.reshape(n, an_num * h * w, 4),
            scores.reshape(n, an_num * h * w, class_num))


# ---------------------------------------------------------------------------
# yolo_loss
# ---------------------------------------------------------------------------

def _sigmoid_ce(x, label):
    return x.clamp(min=0) - x * label + torch.log1p(torch.exp(-x.abs()))


def _iou_cwh(b1, b2):
    """IoU of (cx, cy, w, h) boxes, broadcasting the leading axes."""
    lo = torch.maximum(b1[..., :2] - b1[..., 2:] / 2,
                       b2[..., :2] - b2[..., 2:] / 2)
    hi = torch.minimum(b1[..., :2] + b1[..., 2:] / 2,
                       b2[..., :2] + b2[..., 2:] / 2)
    wh = hi - lo
    inter = torch.where((wh[..., 0] < 0) | (wh[..., 1] < 0), 0.0,
                        wh[..., 0] * wh[..., 1])
    union = b1[..., 2] * b1[..., 3] + b2[..., 2] * b2[..., 3] - inter
    return inter / union.clamp(min=1e-10)


@register_kernel("yolo_loss")
def _yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
               anchor_mask=(), class_num=1, ignore_thresh=0.7,
               downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0):
    """x ``[n, M*(5+C), h, w]``; gt_box ``[n, B, 4]`` normalized (cx cy w
    h); gt_label ``[n, B]``; gt_score ``[n, B]`` (default 1). Returns
    (loss ``[n]``, objectness mask ``[n, M, h, w]``, gt match ``[n, B]``),
    the reference's ``yolo_loss`` (its square-grid decode included)."""
    anchors = [int(a) for a in anchors]
    anchor_mask = [int(a) for a in anchor_mask]
    M = len(anchor_mask)
    n, _, h, w = x.shape
    B = gt_box.shape[1]
    dev = x.device
    input_size = downsample_ratio * h
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    xf = x.reshape(n, M, 5 + class_num, h, w).float()
    gt = gt_box.float()
    gscore = torch.ones((n, B), device=dev) if gt_score is None \
        else gt_score.float()
    valid = (gt[..., 2] > 0) & (gt[..., 3] > 0)
    if use_label_smooth:
        sw = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - sw, sw
    else:
        label_pos, label_neg = 1.0, 0.0

    # the ignore pass: each prediction's best IoU against the valid gts
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(h, w)
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .expand(h, w)
    aw = _const([anchors[2 * m] for m in anchor_mask], dev)[
        None, :, None, None]
    ah = _const([anchors[2 * m + 1] for m in anchor_mask], dev)[
        None, :, None, None]
    with torch.no_grad():
        pred = torch.stack([
            (gx + torch.sigmoid(xf[:, :, 0]) * scale + bias) / h,
            (gy + torch.sigmoid(xf[:, :, 1]) * scale + bias) / h,
            torch.exp(xf[:, :, 2]) * aw / input_size,
            torch.exp(xf[:, :, 3]) * ah / input_size], dim=-1)
        iou = _iou_cwh(pred[:, :, :, :, None, :],
                       gt[:, None, None, None, :, :])    # [n, M, h, w, B]
        iou = torch.where(valid[:, None, None, None, :], iou, 0.0)
        obj_mask = torch.where(iou.amax(dim=-1) > ignore_thresh, -1.0, 0.0)

    # each gt's best anchor by shape IoU, and its positive cell
    aw_all = _const(anchors[0::2], dev) / input_size
    ah_all = _const(anchors[1::2], dev) / input_size
    inter = (torch.minimum(gt[..., 2:3], aw_all[None, None])
             * torch.minimum(gt[..., 3:4], ah_all[None, None]))
    union = (gt[..., 2:3] * gt[..., 3:4]
             + aw_all[None, None] * ah_all[None, None] - inter)
    best_n = torch.argmax(inter / union.clamp(min=1e-10), dim=-1)
    mask_arr = _const(anchor_mask, dev, torch.int64)
    eq = best_n[..., None] == mask_arr[None, None, :]
    mask_idx = torch.where(eq.any(-1), eq.to(torch.int64).argmax(-1), -1)
    gt_match = torch.where(valid, mask_idx, -1)
    gi = (gt[..., 0] * w).to(torch.int64).clamp(0, w - 1)
    gj = (gt[..., 1] * h).to(torch.int64).clamp(0, h - 1)
    pos = valid & (mask_idx >= 0)
    m_safe = mask_idx.clamp(min=0)

    # positives overwrite the ignore marks in gt order (a later gt wins)
    bidx = torch.arange(n, device=dev)
    for t in range(B):
        at = (bidx, m_safe[:, t], gj[:, t], gi[:, t])
        obj_mask = obj_mask.index_put(
            at, torch.where(pos[:, t], gscore[:, t], obj_mask[at]))

    # location and class losses at the positive cells, read by a one-hot
    # product (a deterministic backward)
    cells = (m_safe * h + gj) * w + gi                         # [n, B]
    onehot = (cells[..., None] == torch.arange(
        M * h * w, device=dev)).float()                         # [n, B, Mhw]
    picked = torch.bmm(onehot, xf.permute(0, 1, 3, 4, 2).reshape(
        n, M * h * w, 5 + class_num))                           # [n, B, 5+C]
    tx = gt[..., 0] * w - gi
    ty = gt[..., 1] * h - gj
    tw = torch.log(gt[..., 2].clamp(min=1e-10) * input_size
                   / (aw_all[best_n] * input_size).clamp(min=1e-10))
    th = torch.log(gt[..., 3].clamp(min=1e-10) * input_size
                   / (ah_all[best_n] * input_size).clamp(min=1e-10))
    loc_scale = (2.0 - gt[..., 2] * gt[..., 3]) * gscore
    loc = (_sigmoid_ce(picked[..., 0], tx) + _sigmoid_ce(picked[..., 1], ty)
           + (tw - picked[..., 2]).abs()
           + (th - picked[..., 3]).abs()) * loc_scale
    labels = (gt_label.to(torch.int64)[..., None]
              == torch.arange(class_num, device=dev)).float()
    cls_target = labels * label_pos + (1 - labels) * label_neg
    cls = _sigmoid_ce(picked[..., 5:], cls_target).sum(-1) * gscore
    pos_loss = torch.where(pos, loc + cls, 0.0).sum(dim=1)

    # objectness over the final mask
    obj_logit = xf[:, :, 4]
    obj_pos = torch.where(obj_mask > 1e-5,
                          _sigmoid_ce(obj_logit, 1.0) * obj_mask, 0.0)
    obj_neg = torch.where((obj_mask <= 1e-5) & (obj_mask > -0.5),
                          _sigmoid_ce(obj_logit, 0.0), 0.0)
    obj_loss = (obj_pos + obj_neg).sum(dim=(1, 2, 3))
    return pos_loss + obj_loss, obj_mask, gt_match


# ---------------------------------------------------------------------------
# deformable_conv (v2, modulated)
# ---------------------------------------------------------------------------

@register_kernel("deformable_conv")
def _deformable_conv(x, offset, filter, mask=None, strides=(1, 1),
                     paddings=(0, 0), dilations=(1, 1), deformable_groups=1,
                     groups=1, im2col_step=64):
    """x ``[N,Cin,H,W]``; offset ``[N, 2*dg*kh*kw, Ho, Wo]`` ((dy, dx)
    pairs); mask ``[N, dg*kh*kw, Ho, Wo]`` (None: v1); filter ``[Cout,
    Cin/g, kh, kw]``. The bilinear samples of every tap (zero outside the
    image), then one product with the filter."""
    N, Cin, H, W = x.shape
    Cout, _, kh, kw = filter.shape
    dg = int(deformable_groups)
    pair = (lambda v: (v, v) if isinstance(v, int) else tuple(v))
    (sh, sw), (ph, pw), (dh, dw) = pair(strides), pair(paddings), \
        pair(dilations)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    K = kh * kw
    dev = x.device
    off = offset.float().reshape(N, dg, K, 2, Ho, Wo)
    base_y = (torch.arange(Ho, dtype=torch.float32, device=dev) * sh
              - ph)[:, None]
    base_x = (torch.arange(Wo, dtype=torch.float32, device=dev) * sw
              - pw)[None, :]
    ky = torch.arange(kh, dtype=torch.float32, device=dev) \
        .repeat_interleave(kw) * dh
    kx = (torch.arange(kw, dtype=torch.float32, device=dev) * dw).repeat(kh)
    yy = base_y + ky[:, None, None] + off[:, :, :, 0]      # [N,dg,K,Ho,Wo]
    xx = base_x + kx[:, None, None] + off[:, :, :, 1]
    cg = Cin // dg
    xg = x.float().reshape(N, dg, cg, H * W)
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    sample = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            yi = y0.to(torch.int64) + dy
            xi = x0.to(torch.int64) + dx
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)) \
                .reshape(N, dg, 1, -1).expand(N, dg, cg, K * Ho * Wo)
            v = torch.gather(xg, 3, idx).reshape(N, dg, cg, K, Ho, Wo)
            sample = sample + v * torch.where(ok, wy * wx, 0.0)[:, :, None]
    if mask is not None:
        sample = sample * mask.float().reshape(N, dg, 1, K, Ho, Wo)
    cpg_in, cpg_out = Cin // groups, Cout // groups
    cols = sample.reshape(N, groups, cpg_in, K, Ho, Wo)
    wg = filter.float().reshape(groups, cpg_out, cpg_in, K)
    out = torch.einsum("ngckhw,gock->ngohw", cols, wg)
    return out.reshape(N, Cout, Ho, Wo).to(x.dtype)


# ---------------------------------------------------------------------------
# psroi_pool
# ---------------------------------------------------------------------------

@register_kernel("psroi_pool")
def _psroi_pool(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
                output_channels=1, spatial_scale=1.0):
    """x ``[N, oc*ph*pw, H, W]``; boxes ``[R, 4]``; bin (i, j) of output
    channel c averages input channel ``c*ph*pw + i*pw + j`` over the bin.
    The boxes of each image (counts read on the host) pool in one
    product over that image."""
    _not_captured("psroi_pool")
    N, C, H, W = x.shape
    ph, pw, oc = int(pooled_height), int(pooled_width), int(output_channels)
    R = boxes.shape[0]
    dev = x.device
    counts = [R] if boxes_num is None else \
        [int(c) for c in _np(boxes_num).reshape(-1)]
    b = boxes.float() * spatial_scale
    x0 = torch.round(b[:, 0])
    y0 = torch.round(b[:, 1])
    rw = ((torch.round(b[:, 2]) + 1.0) - x0).clamp(min=0.1)
    rh = ((torch.round(b[:, 3]) + 1.0) - y0).clamp(min=0.1)
    # true divisions (CUDA multiplies by a host scalar's reciprocal, which
    # can move the bins' floor / ceil edges by a pixel)
    bin_h = rh / torch.full_like(rh, float(ph))
    bin_w = rw / torch.full_like(rw, float(pw))
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    i = torch.arange(ph, dtype=torch.float32, device=dev)[None, :, None]
    j = torch.arange(pw, dtype=torch.float32, device=dev)[None, :, None]
    hs = torch.floor(y0[:, None, None] + i * bin_h[:, None, None])
    he = torch.ceil(y0[:, None, None] + (i + 1) * bin_h[:, None, None])
    wss = torch.floor(x0[:, None, None] + j * bin_w[:, None, None])
    wse = torch.ceil(x0[:, None, None] + (j + 1) * bin_w[:, None, None])
    wy = ((ys >= hs.clamp(0, H)) & (ys < he.clamp(0, H))).float()  # [R,ph,H]
    wx = ((xs >= wss.clamp(0, W)) & (xs < wse.clamp(0, W))).float()
    weights = (wy[:, :, None, :, None] * wx[:, None, :, None, :]) \
        .reshape(R, ph * pw, H, W)
    cnt = weights.sum((-2, -1)).clamp(min=1e-10)                 # [R, ph*pw]
    xr = x.float().reshape(N, oc, ph * pw, H, W)
    outs, start = [], 0
    for img, c in enumerate(counts):
        if c:
            wts = weights[start:start + c]
            pooled = torch.einsum("cbhw,rbhw->rcb", xr[img], wts) \
                / cnt[start:start + c, None]
            outs.append(pooled)
        start += c
    out = torch.cat(outs) if outs else x.new_zeros((0, oc, ph * pw)).float()
    return out.reshape(R, oc, ph, pw).to(x.dtype)


# ---------------------------------------------------------------------------
# the NMS family and proposals (host numpy, the reference's order of work)
# ---------------------------------------------------------------------------

def _np_iou_matrix(b, norm=0.0):
    area = (np.maximum(b[:, 2] - b[:, 0] + norm, 0)
            * np.maximum(b[:, 3] - b[:, 1] + norm, 0))
    lo = np.maximum(b[:, None, :2], b[None, :, :2])
    hi = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(hi - lo + norm, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-10)


def _np_iou_row(box, boxes, norm=0.0):
    area = (np.maximum(box[2] - box[0] + norm, 0)
            * np.maximum(box[3] - box[1] + norm, 0))
    areas = (np.maximum(boxes[:, 2] - boxes[:, 0] + norm, 0)
             * np.maximum(boxes[:, 3] - boxes[:, 1] + norm, 0))
    lo = np.maximum(box[None, :2], boxes[:, :2])
    hi = np.minimum(box[None, 2:], boxes[:, 2:])
    wh = np.maximum(hi - lo + norm, 0)
    inter = wh[:, 0] * wh[:, 1]
    return inter / np.maximum(area + areas - inter, 1e-10)


def np_greedy_nms(boxes, scores, thresh, eta=1.0, norm=0.0):
    """Greedy NMS over a stable descending sort; ``eta`` < 1 shrinks the
    threshold after each kept box while it is above 0.5."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    adaptive = float(thresh)
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        iou = _np_iou_row(boxes[i], boxes[order[1:]], norm)
        order = order[1:][iou <= adaptive]
        if eta < 1.0 and adaptive > 0.5:
            adaptive *= eta
    return np.asarray(keep, np.int64)


def _detections(outs, idxs, nums, device):
    out = np.concatenate(outs, 0) if outs else np.zeros((0, 6), np.float32)
    index = (np.concatenate(idxs, 0) if idxs
             else np.zeros((0,), np.int64))[:, None]
    return (_t(out, device), _t(index.astype(np.int64), device),
            _t(np.asarray(nums, np.int64), device))


def _keep_top(dets, det_idx, keep_top_k):
    dets = np.asarray(dets, np.float32).reshape(-1, 6)
    det_idx = np.asarray(det_idx, np.int64)
    if keep_top_k > -1 and len(dets) > keep_top_k:
        top = np.argsort(-dets[:, 1], kind="stable")[:keep_top_k]
        dets, det_idx = dets[top], det_idx[top]
    return dets, det_idx


@register_kernel("multiclass_nms3")
def _multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.0,
                     nms_top_k=-1, keep_top_k=-1, nms_threshold=0.3,
                     normalized=True, nms_eta=1.0, background_label=0):
    """bboxes ``[N, M, 4]``, scores ``[N, C, M]`` -> out ``[T, 6]`` (label,
    score, x1 y1 x2 y2), index ``[T, 1]`` (flat box index), per-image
    counts ``[N]``."""
    _not_captured("multiclass_nms3")
    bb = _np(bboxes).astype(np.float32)
    sc = _np(scores).astype(np.float32)
    N, C, M = sc.shape
    outs, idxs, nums = [], [], []
    for n in range(N):
        dets, det_idx = [], []
        for c in range(C):
            if c == background_label:
                continue
            s = sc[n, c]
            sel = np.nonzero(s > score_threshold)[0]
            if sel.size == 0:
                continue
            if nms_top_k > -1 and sel.size > nms_top_k:
                sel = sel[np.argsort(-s[sel], kind="stable")[:nms_top_k]]
            keep = np_greedy_nms(bb[n, sel], s[sel], nms_threshold, nms_eta,
                                 norm=0.0 if normalized else 1.0)
            for k in sel[keep]:
                dets.append([c, s[k], *bb[n, k]])
                det_idx.append(n * M + k)
        dets, det_idx = _keep_top(dets, det_idx, keep_top_k)
        outs.append(dets)
        idxs.append(det_idx)
        nums.append(len(dets))
    return _detections(outs, idxs, nums, _dev(bboxes))


@register_kernel("matrix_nms")
def _matrix_nms(bboxes, scores, score_threshold=0.0, nms_top_k=-1,
                keep_top_k=-1, post_threshold=0.0, use_gaussian=False,
                gaussian_sigma=2.0, background_label=0, normalized=True):
    """SOLOv2's matrix NMS (each score decayed by its higher-scored
    overlaps at once); the I/O of ``multiclass_nms3``."""
    _not_captured("matrix_nms")
    bb = _np(bboxes).astype(np.float32)
    sc = _np(scores).astype(np.float32)
    N, C, M = sc.shape
    outs, idxs, nums = [], [], []
    for n in range(N):
        dets, det_idx = [], []
        for c in range(C):
            if c == background_label:
                continue
            s = sc[n, c]
            sel = np.nonzero(s > score_threshold)[0]
            if sel.size == 0:
                continue
            order = np.argsort(-s[sel], kind="stable")
            if nms_top_k > -1:
                order = order[:nms_top_k]
            sel = sel[order]
            ss = s[sel]
            iou = np.triu(_np_iou_matrix(
                bb[n, sel], norm=0.0 if normalized else 1.0), 1)
            max_iou = np.max(iou, axis=0, initial=0.0)
            if use_gaussian:
                decay = np.exp((max_iou[:, None] ** 2 - iou ** 2)
                               * gaussian_sigma)
            else:
                decay = (1 - iou) / np.maximum(1 - max_iou[:, None], 1e-10)
            upper = np.triu(np.ones_like(iou), 1) > 0
            ds = ss * np.where(upper, decay, 1.0).min(
                axis=0, initial=1.0, where=upper)
            keep = ds > post_threshold
            for k, d in zip(sel[keep], ds[keep]):
                dets.append([c, d, *bb[n, k]])
                det_idx.append(n * M + k)
        dets, det_idx = _keep_top(dets, det_idx, keep_top_k)
        outs.append(dets)
        idxs.append(det_idx)
        nums.append(len(dets))
    return _detections(outs, idxs, nums, _dev(bboxes))


@register_kernel("generate_proposals")
def _generate_proposals(scores, bbox_deltas, im_shape, anchors, variances,
                        pre_nms_top_n=6000, post_nms_top_n=1000,
                        nms_thresh=0.5, min_size=0.1, eta=1.0,
                        pixel_offset=True):
    """RPN proposals: scores ``[N, A, H, W]``, deltas ``[N, A*4, H, W]``,
    anchors / variances ``[H, W, A, 4]`` -> rois ``[T, 4]``, probs ``[T,
    1]``, counts ``[N]``."""
    _not_captured("generate_proposals")
    sc = _np(scores).astype(np.float32)
    dl = _np(bbox_deltas).astype(np.float32)
    im = _np(im_shape).astype(np.float32)
    an = _np(anchors).astype(np.float32).reshape(-1, 4)
    va = _np(variances).astype(np.float32).reshape(-1, 4)
    N, A, H, W = sc.shape
    off = 1.0 if pixel_offset else 0.0
    rois, probs, nums = [], [], []
    for n in range(N):
        s = sc[n].transpose(1, 2, 0).reshape(-1)
        d = dl[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s, kind="stable")
        if pre_nms_top_n > 0:
            order = order[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], va[order]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + 0.5 * aw
        acy = a[:, 1] + 0.5 * ah
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        bw = np.exp(np.minimum(v[:, 2] * d[:, 2], np.log(1000. / 16.))) * aw
        bh = np.exp(np.minimum(v[:, 3] * d[:, 3], np.log(1000. / 16.))) * ah
        box = np.stack([cx - bw / 2, cy - bh / 2,
                        cx + bw / 2 - off, cy + bh / 2 - off], 1)
        box[:, 0::2] = np.clip(box[:, 0::2], 0, im[n, 1] - off)
        box[:, 1::2] = np.clip(box[:, 1::2], 0, im[n, 0] - off)
        ws = box[:, 2] - box[:, 0] + off
        hs = box[:, 3] - box[:, 1] + off
        ok = (ws >= min_size) & (hs >= min_size)
        box, s = box[ok], s[ok]
        keep = np_greedy_nms(box, s, nms_thresh, eta, norm=off)
        if post_nms_top_n > 0:
            keep = keep[:post_nms_top_n]
        rois.append(box[keep])
        probs.append(s[keep, None])
        nums.append(len(keep))
    dev = _dev(scores)
    rois = np.concatenate(rois, 0) if rois else np.zeros((0, 4), np.float32)
    probs = np.concatenate(probs, 0) if probs else np.zeros((0, 1),
                                                            np.float32)
    return (_t(rois.astype(np.float32), dev),
            _t(probs.astype(np.float32), dev),
            _t(np.asarray(nums, np.int64), dev))


@register_kernel("distribute_fpn_proposals")
def _distribute_fpn_proposals(fpn_rois, rois_num=None, min_level=2,
                              max_level=5, refer_level=4, refer_scale=224,
                              pixel_offset=True):
    """Each roi's FPN level ``floor(refer_level + log2(sqrt(area) /
    refer_scale))``, clamped: the flat tuple (L roi lists, L per-image
    count lists, restore index ``[R, 1]``)."""
    _not_captured("distribute_fpn_proposals")
    rois = _np(fpn_rois).astype(np.float32)
    dev = _dev(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    R = rois.shape[0]
    if rois_num is not None:
        rn = _np(rois_num).astype(np.int64).reshape(-1)
        img_of = np.repeat(np.arange(len(rn)), rn)
        n_imgs = len(rn)
    else:
        img_of = np.zeros((R,), np.int64)
        n_imgs = 1
    w = np.maximum(rois[:, 2] - rois[:, 0] + off, 0)
    h = np.maximum(rois[:, 3] - rois[:, 1] + off, 0)
    lvl = np.floor(refer_level + np.log2(np.sqrt(w * h) / refer_scale + 1e-8))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    multi_rois, multi_nums, order = [], [], []
    for level in range(min_level, max_level + 1):
        sel = np.nonzero(lvl == level)[0]
        multi_rois.append(_t(rois[sel], dev))
        counts = np.bincount(img_of[sel], minlength=n_imgs)
        multi_nums.append(_t(counts.astype(np.int64), dev))
        order.append(sel)
    order = np.concatenate(order) if order else np.zeros((0,), np.int64)
    restore = np.empty((R,), np.int64)
    restore[order] = np.arange(R)
    return (*multi_rois, *multi_nums, _t(restore[:, None], dev))


@register_kernel("nms")
def _nms(boxes, scores=None, iou_threshold=0.3):
    """Greedy hard NMS over ``[N, 4]`` boxes (reference ``nms`` op): the
    kept indices in score order, sorted by numpy's default (unstable)
    ``argsort`` as the reference does, so ties break the same way."""
    _not_captured("nms")
    b = _np(boxes).astype(np.float32)
    s = (_np(scores).astype(np.float32) if scores is not None
         else np.arange(len(b), 0, -1, dtype=np.float32))
    order = np.argsort(-s)
    keep = []
    area = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(b[i, 0], b[rest, 0])
        yy1 = np.maximum(b[i, 1], b[rest, 1])
        xx2 = np.minimum(b[i, 2], b[rest, 2])
        yy2 = np.minimum(b[i, 3], b[rest, 3])
        inter = (xx2 - xx1).clip(0) * (yy2 - yy1).clip(0)
        iou = inter / np.maximum(area[i] + area[rest] - inter, 1e-10)
        order = rest[iou <= iou_threshold]
    return _t(np.asarray(keep, np.int64), _dev(boxes))
