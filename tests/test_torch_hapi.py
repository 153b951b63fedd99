"""``paddle_tpu_torch.hapi`` (``Model``, callbacks) against the reference's
``paddle_tpu.hapi`` on one tiny net (Linear 6x8, Tanh, Linear 8x3, cross
entropy, Adam lr 0.05), same weights, same data, same numpy seeds.

- ``train_batch`` (auto-captured in both packages under
  ``FLAGS_step_capture``): six steps' losses within atol 1e-5 (float32
  matmuls and Adam, summed in another order), the weights within atol
  1e-5 after them;
- ``fit`` over a shuffled DataLoader, two epochs with an eval set: every
  step's loss and the eval losses within atol 1e-5; the callbacks see the
  same events in the same order as the reference's;
- ``fit`` in K-step blocks (``FLAGS_multi_step`` 4, a K-misaligned epoch)
  equals single-step ``fit`` bit for bit (losses and weights);
- ``evaluate``, ``predict`` and ``save``/``load`` round trips, and the
  rules of the port: ``resilience_dir=`` raises naming its ROADMAP item,
  and ``metrics=`` takes ``paddle.metric`` metrics only (TypeError, as
  the reference's); fit with ``metrics=Accuracy()`` is in
  ``test_torch_metric.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import flags as jflags
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.io import DataLoader as JLoader
from paddle_tpu.io import TensorDataset as JData
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.io import DataLoader, TensorDataset


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    # the reference's capture asks jax.core.trace_state_clean, which JAX
    # 0.9 keeps only in jax._src.core: lend it for these runs where missing
    import jax
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jcore
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jcore.trace_state_clean, raising=False)
    tflags.set_flags({"step_capture": True, "multi_step": 0})
    yield
    tflags.set_flags({"step_capture": True, "multi_step": 0})
    jflags.set_flags({"FLAGS_multi_step": 0})


def _data(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 6).astype(np.float32), \
        rng.randint(0, 3, n).astype(np.int64)


def _pair():
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(6, 8), jnn.Tanh(), jnn.Linear(8, 3))
    tnet = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))
    with torch.no_grad():
        for jl, tl in ((jnet[0], tnet[0]), (jnet[2], tnet[2])):
            tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight._data).T))
            tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias._data)))
    jm = JModel(jnet)
    jm.prepare(paddle.optimizer.Adam(learning_rate=0.05,
                                     parameters=jnet.parameters()),
               jnn.CrossEntropyLoss())
    tm = Model(tnet)
    tm.prepare(TO.Adam(learning_rate=0.05, parameters=tnet.parameters()),
               torch.nn.CrossEntropyLoss())
    return jm, tm


def _weights_close(jm, tm, atol=1e-5):
    jn, tn = jm.network, tm.network
    for jl, tl in ((jn[0], tn[0]), (jn[2], tn[2])):
        np.testing.assert_allclose(tl.weight.detach().numpy().T,
                                   np.asarray(jl.weight._data), atol=atol)
        np.testing.assert_allclose(tl.bias.detach().numpy(),
                                   np.asarray(jl.bias._data), atol=atol)


def test_train_batch_tracks_reference():
    jm, tm = _pair()
    x, y = _data()
    jl, tl = [], []
    for i in range(6):
        xb, yb = x[4 * i:4 * i + 4], y[4 * i:4 * i + 4]
        jl.append(float(np.asarray(jm.train_batch([xb], [yb]))))
        tl.append(tm.train_batch([xb], [yb]))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    _weights_close(jm, tm)
    assert tm._captured_step is not None and tm._captured_step.graphs()


class _Events:
    def __init__(self):
        self.log = []

    def make(self, base):
        log = self.log

        class Rec(base):
            def on_train_begin(self, logs=None):
                log.append("train_begin")

            def on_epoch_begin(self, epoch, logs=None):
                log.append(("epoch_begin", epoch))

            def on_train_batch_begin(self, step, logs=None):
                log.append(("batch_begin", step))

            def on_train_batch_end(self, step, logs=None):
                log.append(("batch_end", step, round(logs["loss"], 5)))

            def on_epoch_end(self, epoch, logs=None):
                log.append(("epoch_end", epoch))

            def on_eval_begin(self, logs=None):
                log.append("eval_begin")

            def on_eval_end(self, logs=None):
                log.append(("eval_end", round(logs["loss"], 5)))

            def on_train_end(self, logs=None):
                log.append("train_end")
        return Rec()


def test_fit_losses_and_callback_order_match_reference():
    jm, tm = _pair()
    x, y = _data()
    xe, ye = _data(12, seed=1)
    je, te = _Events(), _Events()
    np.random.seed(3)
    jtrain = JLoader(JData([x, y]), batch_size=6, shuffle=True)
    jeval = JLoader(JData([xe, ye]), batch_size=6)
    np.random.seed(3)
    ttrain = DataLoader(TensorDataset([x, y]), places="cpu", batch_size=6,
                        shuffle=True)
    teval = DataLoader(TensorDataset([xe, ye]), places="cpu", batch_size=6)
    jm.fit(jtrain, jeval, epochs=2, verbose=0,
           callbacks=[je.make(jcb.Callback)])
    tm.fit(ttrain, teval, epochs=2, verbose=0,
           callbacks=[te.make(tcb.Callback)])
    assert [e if isinstance(e, str) else e[:2] for e in je.log] == \
        [e if isinstance(e, str) else e[:2] for e in te.log]
    jl = [e[-1] for e in je.log if isinstance(e, tuple) and len(e) > 1
          and e[0] in ("batch_end", "eval_end")]
    tl = [e[-1] for e in te.log if isinstance(e, tuple) and len(e) > 1
          and e[0] in ("batch_end", "eval_end")]
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    _weights_close(jm, tm)


def _fit(k):
    tflags.set_flags({"multi_step": k})
    _, tm = _pair()
    x, y = _data(44)
    np.random.seed(5)
    loader = DataLoader(TensorDataset([x, y]), places="cpu", batch_size=4,
                        shuffle=True)
    losses = []

    class Record(tcb.ProgBarLogger):     # read-only: blocks stay allowed
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    tm.fit(loader, epochs=2, verbose=0, callbacks=[Record(verbose=0)])
    return losses, [p.detach().clone() for p in tm.network.parameters()], tm


def test_multi_step_fit_equals_single_step_fit():
    ls, ps, _ = _fit(0)
    lm, pm, tm = _fit(4)
    assert tm._multi_step is not None and tm._multi_step.graphs()
    assert len(lm) == 22 and lm == ls
    assert all(torch.equal(a, b) for a, b in zip(ps, pm))


def test_evaluate_predict_save_load(tmp_path):
    _, tm = _pair()
    x, y = _data(12)
    tm.train_batch([x[:4]], [y[:4]])
    logs = tm.evaluate(TensorDataset([x, y]), batch_size=4, verbose=0)
    with torch.no_grad():
        want = float(torch.nn.functional.cross_entropy(
            tm.network(torch.from_numpy(x)), torch.from_numpy(y)))
    assert abs(logs["loss"] - want) < 1e-5
    out = tm.predict(TensorDataset([x]), batch_size=5, stack_outputs=True,
                     verbose=0)
    assert out[0].shape == (12, 3)
    path = str(tmp_path / "ck" / "m")
    tm.save(path)
    _, other = _pair()
    other.load(path)
    for a, b in zip(tm.network.parameters(), other.network.parameters()):
        assert torch.equal(a, b)
    assert other._optimizer._step_count == tm._optimizer._step_count == 1


def test_unported_options_raise_with_their_item():
    _, tm = _pair()
    with pytest.raises(TypeError, match="paddle.metric.Metric"):
        tm.prepare(tm._optimizer, torch.nn.CrossEntropyLoss(),
                   metrics=[object()])
    x, y = _data(8)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tm.fit(TensorDataset([x, y]), resilience_dir="/nonexistent",
               verbose=0)
