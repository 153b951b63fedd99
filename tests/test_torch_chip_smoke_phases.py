"""``chip_smoke.py``'s BERT and OCR phases' inputs and reckoning, on the
CPU: the SQuAD-shaped batch (a padded tail of 10-30% a row, question and
context type ids, each span inside its row's context), the CRNN batch
(labels of 1-25 symbols, none the blank, zero-padded), and the FLOPs a
token of BERT-base (6 N + 12 layers hidden seq, N the non-embedding
parameters: 2.55 TFLOP a step at 12 x 384), counted on meta parameters.
Importing the script needs no card."""

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
