"""The port's BERT (``models/bert.py``) against the JAX package's, on the
CPU, at ``BertConfig.tiny()`` with converted weights.

Forward (float32, atol 1e-4): the question-answering head's start and end
logits and the classification logits, with and without a padding mask.
Training with dropout 0: three ``TrainStep``s of the SQuAD loss (the
mean of the start and end cross entropies) under AdamW with weight decay
and global-norm clip, the port's captured ``TrainStep`` against the
reference's ``TrainStep``, losses within rtol 1e-4. Also: the padding
mask's additive form, the default position and token-type ids, the
parameter names, the dropout masks of the layer copies, and with dropout
0.1 the captured ``TrainStep`` equal to its eager steps bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as JO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import from_jax_state_dict
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

ATOL = 1e-4
B, S = 2, 16


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _cfg(pkg, dropout=0.0):
    return dataclasses.replace(pkg.BertConfig.tiny(),
                               hidden_dropout_prob=dropout,
                               attention_probs_dropout_prob=dropout)


def _pair(cls, **kw):
    paddle.seed(0)
    jm = getattr(jbert, cls)(_cfg(jbert), **kw)
    tm = getattr(tbert, cls)(_cfg(tbert), **kw)
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (B, S)).astype(np.int32)
    types = (np.arange(S) >= S // 2).astype(np.int32)[None].repeat(B, 0)
    mask = np.ones((B, S), np.int32)
    mask[1, -5:] = 0
    start = rng.randint(0, S - 5, B).astype(np.int32)
    end = np.minimum(start + rng.randint(0, 4, B), S - 6).astype(np.int32)
    return ids, types, mask, start, end


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_qa_logits_match_reference(masked):
    jm, tm = _pair("BertForQuestionAnswering")
    jm.eval()
    tm.eval()
    ids, types, mask, _, _ = _batch()
    kw_j = dict(token_type_ids=Tensor(types))
    kw_t = dict(token_type_ids=torch.from_numpy(types))
    if masked:
        kw_j["attention_mask"] = Tensor(mask)
        kw_t["attention_mask"] = torch.from_numpy(mask)
    want = jm(Tensor(ids), **kw_j)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), **kw_t)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, S)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)


def test_classification_logits_match_reference():
    jm, tm = _pair("BertForSequenceClassification", num_classes=3)
    jm.eval()
    tm.eval()
    ids, _, mask, _, _ = _batch(1)
    want = jm(Tensor(ids), attention_mask=Tensor(mask)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _squad_loss_j(start_logits, end_logits, start, end):
    return (JF.cross_entropy(start_logits, start)
            + JF.cross_entropy(end_logits, end)) / 2


def _squad_loss_t(start_logits, end_logits, start, end):
    return (TF.cross_entropy(start_logits, start)
            + TF.cross_entropy(end_logits, end)) / 2


def test_three_train_steps_track_reference():
    jm, tm = _pair("BertForQuestionAnswering")
    ids, types, mask, start, end = _batch(2)
    jopt = JO.AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=jm.parameters(),
                    grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jtrain = JTrainStep(jm, _squad_loss_j, jopt)
    topt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                 parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    ttrain = TrainStep(tm, _squad_loss_t, topt)
    jin = (Tensor(ids), Tensor(types), None, Tensor(mask))
    tin = (torch.from_numpy(ids), torch.from_numpy(types), None,
           torch.from_numpy(mask))
    jl = [float(jtrain(jin, (Tensor(start), Tensor(end)))._data)
          for _ in range(3)]
    tl = [float(ttrain(tin, (torch.from_numpy(start),
                             torch.from_numpy(end)))) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[2] < tl[0]


def test_padding_mask_and_default_ids():
    _, tm = _pair("BertForQuestionAnswering")
    tm.eval()
    ids, _, mask, _, _ = _batch(3)
    t_ids = torch.from_numpy(ids)
    with torch.no_grad():
        a = tm.bert(t_ids)[0]
        b = tm.bert(t_ids, token_type_ids=torch.zeros_like(t_ids),
                    position_ids=torch.arange(S)[None])[0]
        full = tm.bert(t_ids, attention_mask=torch.ones(B, S))[0]
    assert torch.equal(a, b) and torch.equal(a, full)


def test_parameter_names_and_layer_dropouts():
    jm, tm = _pair("BertForQuestionAnswering")
    assert set(tm.state_dict()) == set(jm.state_dict())
    assert "bert.encoder.layers.1.self_attn.q_proj.weight" in \
        tm.state_dict()
    cfg = tbert.BertConfig.tiny()
    model = tbert.BertForQuestionAnswering(cfg)
    layers = model.bert.encoder.layers
    x = torch.ones(1, 256)
    assert not torch.equal(layers[0].dropout1(x), layers[1].dropout1(x))
    assert layers[0].self_attn.dropout == cfg.attention_probs_dropout_prob


def test_captured_steps_with_dropout_equal_eager():
    """Dropout 0.1 on (the layers' own generators and the attention
    op's draws from the port's generator): the captured ``TrainStep``'s
    losses equal ``FLAGS_step_capture=0``'s from the same seed, bit for
    bit, and differ from a dropout-free run."""
    import paddle_tpu_torch
    from paddle_tpu_torch import flags
    ids, types, mask, start, end = (torch.from_numpy(a) for a in _batch(4))

    def run(capture, dropout=0.1):
        paddle_tpu_torch.seed(3)
        model = tbert.BertForQuestionAnswering(_cfg(tbert, dropout))
        train = TrainStep(model, _squad_loss_t, AdamW(
            learning_rate=1e-3, parameters=model.parameters()))
        flags.set_flags({"step_capture": capture})
        try:
            return [float(train((ids, types, None, mask), (start, end)))
                    for _ in range(4)]
        finally:
            flags.set_flags({"step_capture": True})

    captured = run(True)
    assert captured == run(False)
    assert captured != run(True, dropout=0.0)
