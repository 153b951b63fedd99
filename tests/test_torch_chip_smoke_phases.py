"""``chip_smoke.py``'s BERT and OCR phases' inputs and reckoning, on the
CPU: the SQuAD-shaped batch (a padded tail of 10-30% a row, question and
context type ids, each span inside its row's context), the CRNN batch
(labels of 1-25 symbols, none the blank, zero-padded), and the FLOPs a
token of BERT-base (6 N + 12 layers hidden seq, N the non-embedding
parameters: 2.55 TFLOP a step at 12 x 384), counted on meta parameters.
The vision phases' inputs and checks: the CIFAR-10-format file the fit
reads (``vision.datasets.Cifar10`` reads it back), YOLOv3's gts (1-50 an
image, zero rows after), MFU's reckoning, the fused-route counters and
the run checks that must reject a broken run. Importing the script needs
no card."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_phases_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_squad_batch_pads_and_spans(smoke):
    ids, types, mask, start, end = smoke.squad_batch(torch, 0, 30522, "cpu")
    assert ids.shape == (smoke.BERT_B, smoke.BERT_S)
    pad = 1.0 - mask.float().mean(1)
    assert bool(((pad >= 0.10 - 1 / smoke.BERT_S) & (pad <= 0.30)).all())
    assert bool((ids[mask == 0] == 0).all())
    assert bool((ids < 30522).all())
    rows = torch.arange(smoke.BERT_B)
    for pos in (start, end):
        assert bool((types[rows, pos] == 1).all())
        assert bool((mask[rows, pos] == 1).all())
    assert bool((start <= end).all())
    again = smoke.squad_batch(torch, 0, 30522, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, (ids, types, mask,
                                                         start, end)))


def test_ocr_batch_labels(smoke):
    imgs, labels, lens = smoke.ocr_batch(torch, 0, "cpu")
    assert imgs.shape == (smoke.OCR_B, 3, smoke.OCR_H, smoke.OCR_W)
    assert int(lens.min()) >= 1 and int(lens.max()) <= smoke.OCR_MAX_LEN
    pos = torch.arange(smoke.OCR_MAX_LEN)[None, :]
    live = pos < lens[:, None]
    assert bool((labels[live] >= 1).all()) and bool((labels[~live] == 0)
                                                   .all())
    assert int(labels.max()) < smoke.OCR_CLASSES


def test_bert_base_flops_per_token(smoke):
    from paddle_tpu_torch.core.device import set_device
    from paddle_tpu_torch.models import BertConfig, BertForQuestionAnswering
    from paddle_tpu_torch.nn import LazyGuard
    set_device("cpu")
    try:
        with LazyGuard():
            model = BertForQuestionAnswering(BertConfig.base())
    finally:
        set_device(None)
    flops, n = smoke.bert_flops_per_token(model, BertConfig.base(),
                                          smoke.BERT_S)
    assert n == 85_056_002
    assert flops == 6 * n + 12 * 12 * 768 * 384
    step = flops * smoke.BERT_B * smoke.BERT_S
    assert np.isclose(step / 1e12, 2.547, atol=1e-3)


def test_eager_surface_moment_checks(smoke):
    """Phase ``eager_surface``'s random checks on the CPU at 2^16 draws:
    every draw passes its law's limits, a draw whose mean moves by 10
    standard errors (or one outside the support) fails them, and the same seed repeats the
    bytes with torch's global seed moved between."""
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    try:
        paddle.seed(0)
        for name, (draw, _, _) in smoke.RANDOM_DRAWS.items():
            t = draw(paddle, 1 << 16)
            stats = smoke.draw_stats(torch, t)
            assert smoke.moment_errors(name, stats) == [], name
            n, m, s, lo, hi = stats
            assert smoke.moment_errors(name, (n, m + 10 * s / n ** 0.5, s,
                                              lo, hi))
            if smoke.RANDOM_DRAWS[name][2] is not None:
                assert smoke.moment_errors(name, (n, m, s, lo - 1, hi))
            paddle.seed(5)
            a = draw(paddle, 1000)
            paddle.seed(5)
            torch.manual_seed(77)
            assert torch.equal(a, draw(paddle, 1000))
    finally:
        paddle.set_device(None)


def test_eager_surface_wgan_gp_and_loop_on_the_cpu(smoke):
    """The phase's WGAN-GP step gives the reference test's penalty grads
    (finite, the last bias unreached: zeros), and its Paddle loop over a
    tiny Llama returns ``Tensor`` logits and ``numpy()`` equal to
    ``item()``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW
    paddle.set_device("cpu")
    try:
        out = smoke.wgan_gp(paddle)
        assert len(out) == 5 and all(np.isfinite(o).all() for o in out)
        assert not out[4].any() and out[1].any()
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        paddle.seed(0)
        x = paddle.randint(0, 256, [2, 33])[:, :-1]
        run = smoke.paddle_train_loop(torch, paddle, model,
                                      LlamaPretrainingCriterion(), opt, x, 3)
        assert run["last_numpy"] == run["last_item"]
        assert len(run["step_s"]) == 1 and run["losses"][2] < run["losses"][0]
    finally:
        paddle.set_device(None)


def test_vision_cifar_file_reads_back(smoke, tmp_path):
    from paddle_tpu_torch.vision import datasets
    path = smoke.write_cifar10(str(tmp_path / "c.tar.gz"), 3, 80, 16)
    train = datasets.Cifar10(path, mode="train")
    test = datasets.Cifar10(path, mode="test")
    assert len(train) == 80 and len(test) == 16
    img, label = train[5]
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert 0 <= int(label) < 10
    again = smoke.write_cifar10(str(tmp_path / "d.tar.gz"), 3, 80, 16)
    assert np.array_equal(datasets.Cifar10(again)[5][0], img)


def test_yolo_batch_gts(smoke):
    x, box, lab, score = smoke.yolo_batch(torch, 0, "cpu")
    assert x.shape == (smoke.YOLO_B, 3, smoke.YOLO_SIZE, smoke.YOLO_SIZE)
    live = box[..., 2] > 0
    n = live.sum(1)
    assert int(n.min()) >= 1 and int(n.max()) <= smoke.YOLO_GTS
    for i in range(smoke.YOLO_B):       # live rows first, then zero rows
        k = int(n[i])
        assert bool(live[i, :k].all()) and not bool(box[i, k:].any())
    assert bool((box[live][:, :2] > 0).all() and (box[live] < 1).all())
    assert int(lab.max()) < smoke.YOLO_CLASSES and bool((score == 1).all())


def test_vision_mfu_and_fused_route(smoke):
    run = {"images_per_s": 1000.0}
    mfu = smoke.vision_mfu(run, smoke.R50_MACS, 64, smoke.F32_FLOPS_PER_S)
    assert mfu == pytest.approx(1000 * 24.6e9 / 67e12)
    before = {"updates": 3, "fallbacks": 1, "buckets": 1}
    ok = smoke.fused_route(before, {"updates": 15, "fallbacks": 1,
                                    "buckets": 1}, 12)
    assert ok["every_step_fused"] and ok["updates"] == 12
    assert not smoke.fused_route(before, {"updates": 14, "fallbacks": 2,
                                          "buckets": 1}, 12)[
        "every_step_fused"]


def test_check_vision_runs_rejects_broken_runs(smoke):
    good = {"losses": [3.0, 2.0, 1.0], "fused_optimizer_launches": 3,
            "fused_route": {"every_step_fused": True}}
    runs = {"captured": good, "eager": dict(good)}
    smoke.check_vision_runs("t", runs, falling=("captured",))
    for bad, match in (
            ({"eager": dict(good, losses=[3.0, 2.0, 1.0000001])}, "differ"),
            ({"eager": dict(good, losses=[3.0, float("nan"), 1.0])},
             "finite"),
            ({"captured": dict(good, fused_route={
                "every_step_fused": False})}, "fused"),
            ({"captured": dict(good, fused_optimizer_launches=0)},
             "fused")):
        with pytest.raises(AssertionError, match=match):
            smoke.check_vision_runs("t", {**runs, **bad})
    rising = dict(good, losses=[1.0, 2.0, 3.0])
    with pytest.raises(AssertionError, match="falling"):
        smoke.check_vision_runs("t", {"captured": rising,
                                      "eager": dict(rising)},
                                falling=("captured",))
