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
