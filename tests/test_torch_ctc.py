"""The port's sequence losses (``ops/kernels/rnn.py``: ``ctc_loss``,
``rnnt_loss``; ``nn.functional.ctc_loss`` / ``rnnt_loss`` with their
reductions) against the JAX package's, on the CPU: loss values and the
grads of the logits, float32 atol 1e-5 (rtol 1e-5).

CTC: labels with repeats (the blank a repeat must pass through), a label
of length 0, input lengths below T, ``norm_by_times``, every reduction,
and torch's ``F.ctc_loss`` as a yardstick where both are finite. RNN-T:
``fastemit_lambda`` 0 and 0.01 (the emit arcs' grads scaled, the value
untouched), label and input lengths below the lattice's, every
reduction.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.nn import functional as TF

from _torch_op_check import check_op

TOL = dict(atol=1e-5, rtol=1e-5)
T, B, C, L = 12, 4, 6, 4


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _ctc_inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, B, C).astype(np.float32)
    labels = rng.randint(1, C, (B, L)).astype(np.int32)
    labels[0, 1] = labels[0, 0]                     # a repeat
    in_len = np.array([12, 9, 12, 7], np.int32)
    lab_len = np.array([4, 3, 0, 2], np.int32)      # row 2: empty label
    return logits, labels, in_len, lab_len


def _log_softmax(x, axis=-1):
    m = x.max(axis, keepdims=True)
    return (x - m - np.log(np.exp(x - m).sum(axis, keepdims=True))
            ).astype(np.float32)


@pytest.mark.parametrize("norm", [False, True], ids=["plain", "norm_by_times"])
@pytest.mark.parametrize("blank", [0, 3])
def test_ctc_loss_op_matches_reference(blank, norm):
    logits, labels, in_len, lab_len = _ctc_inputs(blank)
    labels = np.where(labels == blank, (blank + 1) % C, labels)
    check_op("ctc_loss", [_log_softmax(logits), labels, in_len, lab_len],
             dict(blank=blank, norm_by_times=norm), **TOL)


def _functional(jf, tf, inputs, grad_index, **kw):
    """``jf`` / ``tf`` on the same numpy inputs (``grad_index``
    differentiated): values and that input's grad under a cotangent."""
    jx = [Tensor(a, stop_gradient=i != grad_index)
          for i, a in enumerate(inputs)]
    tx = [torch.from_numpy(a.copy()) for a in inputs]
    tx[grad_index].requires_grad_(True)
    jout, tout = jf(*jx, **kw), tf(*tx, **kw)
    ct = np.asarray(np.random.RandomState(3).randn(*jout.shape), np.float32)
    (jout * Tensor(ct)).sum().backward()
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    np.testing.assert_allclose(tx[grad_index].grad.numpy(),
                               jx[grad_index].grad.numpy(), **TOL)
    return tout


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_functional_ctc_loss_matches_reference(reduction):
    logits, labels, in_len, lab_len = _ctc_inputs(1)
    lab_len[2] = 1          # mean divides by the label lengths
    _functional(JF.ctc_loss, TF.ctc_loss, [logits, labels, in_len, lab_len],
                0, reduction=reduction)


def test_ctc_loss_against_torch_ctc_loss():
    """torch's own CTC (the yardstick on the card) agrees where both are
    finite: every sequence here is feasible."""
    logits, labels, in_len, lab_len = _ctc_inputs(2)
    lp = torch.from_numpy(_log_softmax(logits))
    got = TF.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(in_len), torch.from_numpy(lab_len),
                      reduction="none")
    want = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(labels).long(), torch.from_numpy(in_len).long(),
        torch.from_numpy(lab_len).long(), blank=0, reduction="none")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def _rnnt_inputs(seed=0, U=4, V=5, Tn=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, Tn, U, V).astype(np.float32)
    label = rng.randint(1, V, (B, U - 1)).astype(np.int32)
    in_len = np.array([6, 4, 6, 1], np.int32)
    lab_len = np.array([3, 1, 0, 2], np.int32)
    return logits, label, in_len, lab_len


@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_rnnt_loss_op_matches_reference(lam):
    check_op("rnnt_loss", list(_rnnt_inputs()),
             dict(fastemit_lambda=lam), **TOL)


def test_rnnt_fastemit_scales_grads_not_the_value():
    inputs = [torch.from_numpy(a) for a in _rnnt_inputs(4)]
    outs = []
    for lam in (0.0, 0.5):
        x = inputs[0].clone().requires_grad_(True)
        loss = TF.rnnt_loss(x, *inputs[1:], fastemit_lambda=lam,
                            reduction="sum")
        loss.backward()
        outs.append((loss.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.allclose(outs[0][1], outs[1][1])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_functional_rnnt_loss_matches_reference(reduction):
    _functional(JF.rnnt_loss, TF.rnnt_loss, list(_rnnt_inputs(5)), 0,
                reduction=reduction, fastemit_lambda=0.01)
