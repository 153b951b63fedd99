"""The port's PP-OCR models (``models/ocr.py``: ``CRNN`` + ``CTCHeadLoss``,
``DBNet`` + ``DBLoss``) against the JAX package's, on the CPU, at small
sizes (CRNN at 32 x 64 with hidden 16; DBNet at 64 x 64), with converted
weights and BatchNorm buffers.

Forward (float32, atol 1e-4): CRNN's ``[T, B, C]`` logits and DBNet's
three maps, in eval mode (running statistics) and in train mode (batch
statistics). Training: three ``TrainStep``s under Adam, the port's
captured step against the reference's ``TrainStep``, losses within rtol
1e-4, and the BatchNorm statistics they leave.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as JO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import ocr as jocr
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import from_jax_state_dict
from paddle_tpu_torch.models import ocr as tocr
from paddle_tpu_torch.optimizer import Adam

ATOL = 1e-4
CLASSES, HIDDEN = 11, 16


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _pair(cls, **kw):
    paddle.seed(0)
    jm = getattr(jocr, cls)(**kw)
    tm = getattr(tocr, cls)(**kw)
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _crnn():
    return _pair("CRNN", num_classes=CLASSES, hidden_size=HIDDEN)


def _images(b, h, w, seed=0):
    return np.random.RandomState(seed).rand(b, 3, h, w).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_crnn_logits_match_reference(train):
    jm, tm = _crnn()
    if not train:
        jm.eval()
    tm.train(train)
    x = _images(2, 32, 64)
    want = jm(Tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (17, 2, CLASSES)   # W / 4 + 1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dbnet_maps_match_reference(train):
    jm, tm = _pair("DBNet")
    if not train:
        jm.eval()
    tm.train(train)
    x = _images(1, 64, 64, seed=1)
    want = jm(Tensor(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for key in ("maps", "prob", "thresh", "binary"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert tuple(got["maps"].shape) == (1, 3, 64, 64)


def _ctc_batch(b, seed=0):
    rng = np.random.RandomState(seed)
    lab_len = rng.randint(1, 6, b).astype(np.int32)
    labels = np.zeros((b, 6), np.int32)
    for i, n in enumerate(lab_len):
        labels[i, :n] = rng.randint(1, CLASSES, n)
    return labels, lab_len


def _train(jm, tm, loss_cls, inputs, labels, steps=3):
    jtrain = JTrainStep(jm, loss_cls(), JO.Adam(learning_rate=1e-3,
                                                parameters=jm.parameters()))
    ttrain = TrainStep(tm, getattr(tocr, loss_cls.__name__)(),
                       Adam(learning_rate=1e-3, parameters=tm.parameters()))
    jl = [float(jtrain(tuple(Tensor(a) for a in inputs),
                       tuple(Tensor(a) for a in labels))._data)
          for _ in range(steps)]
    tl = [float(ttrain(tuple(torch.from_numpy(a) for a in inputs),
                       tuple(torch.from_numpy(a) for a in labels)))
          for _ in range(steps)]
    return jl, tl


def test_crnn_three_train_steps_track_reference():
    jm, tm = _crnn()
    labels, lab_len = _ctc_batch(4)
    jl, tl = _train(jm, tm, jocr.CTCHeadLoss, [_images(4, 32, 64, seed=2)],
                    [labels, lab_len])
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[2] < tl[0]
    jstate, tstate = jm.state_dict(), tm.state_dict()
    for name in jstate:
        if name.endswith(("_mean", "_variance")):
            np.testing.assert_allclose(tstate[name].numpy(),
                                       np.asarray(jstate[name]._data),
                                       atol=1e-4, rtol=1e-4, err_msg=name)


def test_dbnet_three_train_steps_track_reference():
    jm, tm = _pair("DBNet")
    rng = np.random.RandomState(3)
    gt_prob = (rng.rand(2, 1, 64, 64) > 0.7).astype(np.float32)
    gt_thresh = rng.rand(2, 1, 64, 64).astype(np.float32)
    gt_mask = (rng.rand(2, 1, 64, 64) > 0.5).astype(np.float32)
    jl, tl = _train(jm, tm, jocr.DBLoss, [_images(2, 64, 64, seed=4)],
                    [gt_prob, gt_thresh, gt_mask])
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[2] < tl[0]


def test_ctc_head_fills_the_input_lengths():
    logits = torch.randn(16, 3, CLASSES)
    labels, lab_len = _ctc_batch(3, seed=5)
    head = tocr.CTCHeadLoss()
    from paddle_tpu_torch.nn import functional as TF
    want = TF.ctc_loss(logits, torch.from_numpy(labels),
                       torch.full((3,), 16), torch.from_numpy(lab_len))
    torch.testing.assert_close(head(logits, torch.from_numpy(labels),
                                    torch.from_numpy(lab_len)), want)
