"""The port's YOLOv3-DarkNet53 (``vision/models/yolov3.py``) against the
JAX package's, on the CPU, with ``backbone_depths=(1, 1, 1, 1, 1)`` at
96 x 96 and 4 classes, the reference's weights carried across with
``models.from_jax_state_dict``: the three heads (atol 1e-4), the loss over
seeded gt boxes (3 to 6 an image, the rest padding rows; rtol 1e-4), three
``TrainStep``s with ``Momentum`` (lr 1e-4, momentum 0.9, L2 decay 1e-4),
and ``predict`` (``yolo_box`` + ``multiclass_nms3``): the same
detections, label for label and index for index, boxes and scores within
1e-4 (absolute and relative: boxes are in pixels).

The training steps: the first loss within rtol 1e-4 and the later two
within rtol 1e-2, each package's losses falling. At random init this
net's grads are ill-conditioned: each conv-BN-LeakyReLU layer's VJP
agrees with the reference's within 1e-7 on its own, but the whole net's
parameter grads differ by ~1e-2 in float32 (large activations of both
signs summed), and so does one step's update.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.models import from_jax_state_dict
from paddle_tpu_torch.vision import models as tmodels

from test_torch_vision_models import ATOL, LOSS_RTOL, _images, _train_both


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


YOLO_KW = dict(num_classes=4, backbone_depths=(1, 1, 1, 1, 1))
YOLO_B, YOLO_SIZE, YOLO_GTS = 2, 96, 8


def yolo_targets(seed=0):
    """Normalized (cx, cy, w, h) gts, labels and mixup scores: 3 to 6 gts
    an image, the rest zeros (padding)."""
    r = np.random.RandomState(seed)
    box = np.zeros((YOLO_B, YOLO_GTS, 4), np.float32)
    lab = np.zeros((YOLO_B, YOLO_GTS), np.int32)
    for i in range(YOLO_B):
        n = r.randint(3, 7)
        box[i, :n, :2] = r.uniform(0.1, 0.9, (n, 2))
        box[i, :n, 2:] = r.uniform(0.05, 0.8, (n, 2))
        lab[i, :n] = r.randint(0, YOLO_KW["num_classes"], n)
    score = r.uniform(0.6, 1.0, (YOLO_B, YOLO_GTS)).astype(np.float32)
    return box, lab, score


def _yolo_pair():
    paddle.seed(0)
    jm = jmodels.yolov3_darknet53(**YOLO_KW)
    tm = tmodels.yolov3_darknet53(**YOLO_KW)
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def test_yolov3_heads_and_loss_match_reference():
    jm, tm = _yolo_pair()
    x = _images(YOLO_B, (3, YOLO_SIZE, YOLO_SIZE))
    box, lab, score = yolo_targets()
    jouts = jm(Tensor(x))
    touts = tm(torch.from_numpy(x))
    for i, (j, t) in enumerate(zip(jouts, touts)):
        s = YOLO_SIZE // (32 // 2 ** i)
        assert tuple(t.shape) == (YOLO_B, 3 * (5 + 4), s, s)
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=ATOL,
                                   rtol=0, err_msg=f"head {i}")
    want = float(jm.loss(jouts, Tensor(box), Tensor(lab),
                         Tensor(score))._data)
    got = float(tm.loss(touts, torch.from_numpy(box), torch.from_numpy(lab),
                        torch.from_numpy(score)).detach())
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_yolov3_three_momentum_steps_track_reference():
    jm, tm = _yolo_pair()
    x = _images(YOLO_B, (3, YOLO_SIZE, YOLO_SIZE), seed=3)
    box, lab, score = yolo_targets(seed=4)

    def jloss(o1, o2, o3, b, lb, s):
        return jm.loss([o1, o2, o3], b, lb, s)

    def tloss(o1, o2, o3, b, lb, s):
        return tm.loss([o1, o2, o3], b, lb, s)
    jl, tl = _train_both(jm, tm, jloss, tloss, [x], [box, lab, score],
                         lr=1e-4)
    assert tl[0] == pytest.approx(jl[0], rel=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=1e-2, atol=0)
    assert tl[2] < tl[1] < tl[0] and jl[2] < jl[1] < jl[0]


def test_yolov3_predict_matches_reference():
    """``predict`` at a low confidence threshold (random weights score
    low): the same detections, label for label, box for box."""
    jm, tm = _yolo_pair()
    jm.eval()
    tm.eval()
    x = _images(1, (3, YOLO_SIZE, YOLO_SIZE), seed=5)
    size = np.array([[YOLO_SIZE, YOLO_SIZE]], np.int32)
    jout, jidx, jnum = jm.predict(Tensor(x), Tensor(size), conf_thresh=0.05,
                                  keep_top_k=50)
    with torch.no_grad():
        tout, tidx, tnum = tm.predict(torch.from_numpy(x),
                                      torch.from_numpy(size),
                                      conf_thresh=0.05, keep_top_k=50)
    assert int(tnum[0]) == int(np.asarray(jnum.numpy())[0]) > 0
    np.testing.assert_array_equal(tout[:, 0].numpy(), jout.numpy()[:, 0])
    np.testing.assert_array_equal(tidx.numpy().ravel(),
                                  np.asarray(jidx.numpy()).ravel())
    np.testing.assert_allclose(tout[:, 1:].numpy(), jout.numpy()[:, 1:],
                               atol=ATOL, rtol=1e-4)
