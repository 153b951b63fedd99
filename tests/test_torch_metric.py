"""``paddle_tpu_torch.metric`` against the JAX package's ``metric``, on
the CPU: ``Accuracy`` (top-1 and top-k, index, one-hot and binary labels),
``Precision``, ``Recall`` and ``Auc`` fed the same seeded batches give the
same per-batch results, ``accumulate()`` and names (exactly: they count);
``reset()`` clears them. Then ``hapi.Model.prepare(metrics=Accuracy())``:
``fit`` over two epochs with an eval set logs the reference's accuracy
at every step and at each evaluation, single-step and in K-step blocks,
and ``evaluate`` returns it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
from paddle_tpu import flags as jflags
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.hapi import Model as JModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.core.tensor import to_tensor
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.io import TensorDataset


@pytest.fixture(autouse=True)
def _cpu_and_flags(monkeypatch):
    import jax
    if not hasattr(jax.core, "trace_state_clean"):
        from jax._src import core as jcore
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jcore.trace_state_clean, raising=False)
    set_device("cpu")
    tflags.set_flags({"step_capture": True, "multi_step": 0})
    yield
    tflags.set_flags({"step_capture": True, "multi_step": 0})
    jflags.set_flags({"FLAGS_multi_step": 0})
    set_device(None)


def _batches(n=4, b=16, c=7, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(b, c).astype(np.float32),
             r.randint(0, c, (b, 1)).astype(np.int64)) for _ in range(n)]


def _run_pair(make, batches, compute=True):
    out = []
    for mod, wrap in ((tmetric, torch.from_numpy), (jmetric, JTensor)):
        m = make(mod)
        per = []
        for pred, label in batches:
            args = (wrap(pred), wrap(label))
            if compute:
                args = m.compute(*args)
                args = args if isinstance(args, (list, tuple)) else (args,)
            per.append(m.update(*args))
        out.append((per, m.accumulate(), m.name()))
    return out


@pytest.mark.parametrize("topk", [(1,), (1, 3), 5], ids=["top1", "top1_3",
                                                         "top5"])
def test_accuracy_matches_reference(topk):
    got, want = _run_pair(lambda M: M.Accuracy(topk=topk), _batches())
    assert got == want


def test_accuracy_one_hot_and_binary_labels():
    r = np.random.RandomState(1)
    onehot = [(p, np.eye(7, dtype=np.float32)[l[:, 0]])
              for p, l in _batches(seed=2)]
    got, want = _run_pair(lambda M: M.Accuracy(topk=(1, 2)), onehot)
    assert got == want
    binary = [(r.rand(10).astype(np.float32),
               r.randint(0, 2, 10).astype(np.int64)) for _ in range(3)]
    got, want = _run_pair(lambda M: M.Accuracy(), binary)
    assert got == want


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_reference(cls):
    r = np.random.RandomState(3)
    batches = [(r.rand(20).astype(np.float32),
                r.randint(0, 2, 20).astype(np.int64)) for _ in range(4)]
    if cls == "Auc":
        batches.append((np.stack([1 - batches[0][0], batches[0][0]], 1),
                        batches[0][1]))
    got, want = _run_pair(lambda M: getattr(M, cls)(), batches,
                          compute=False)
    assert got[1] == pytest.approx(want[1], rel=1e-12) and got[2] == want[2]


def test_reset_clears_and_name_forms():
    m = tmetric.Accuracy(topk=(1, 5), name="a")
    assert m.name() == ["a_top1", "a_top5"]
    m.update(m.compute(torch.eye(6), torch.arange(6)))
    assert m.accumulate() == [1.0, 1.0]
    m.reset()
    assert m.accumulate() == [0.0, 0.0]
    assert isinstance(tmetric.Metric, type)
    with pytest.raises(TypeError):
        tmetric.Metric()


def _data(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 6).astype(np.float32), \
        rng.randint(0, 3, (n, 1)).astype(np.int64)


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
               jnn.CrossEntropyLoss(), metrics=jmetric.Accuracy(topk=(1, 2)))
    tm = Model(tnet)
    tm.prepare(TO.Adam(learning_rate=0.05, parameters=tnet.parameters()),
               lambda out, y: torch.nn.functional.cross_entropy(
                   out, y.reshape(-1)),
               metrics=tmetric.Accuracy(topk=(1, 2)))
    return jm, tm


def _recorder(base, log):
    class Rec(base):
        def on_train_batch_end(self, step, logs=None):
            log.append(("train", step, round(logs["loss"], 5),
                        logs["acc_top1"], logs["acc_top2"]))

        def on_eval_end(self, logs=None):
            log.append(("eval", round(logs["loss"], 5), logs["acc_top1"],
                        logs["acc_top2"]))
    return Rec()


@pytest.mark.parametrize("k", [0, 4], ids=["single_step", "k4_blocks"])
def test_fit_logs_the_references_accuracy(k):
    x, y = _data()
    ex, ey = _data(12, seed=1)
    jm, tm = _pair()
    jlog, tlog = [], []
    from paddle_tpu.io import DataLoader as JLoader
    from paddle_tpu.io import TensorDataset as JData
    jm.fit(JLoader(JData([x, y]), batch_size=6, shuffle=False),
           JLoader(JData([ex, ey]), batch_size=6), epochs=2, verbose=0,
           callbacks=[_recorder(jcb.Callback, jlog)])
    tflags.set_flags({"multi_step": k})
    tm.fit(TensorDataset([to_tensor(x), to_tensor(y)]),
           TensorDataset([to_tensor(ex), to_tensor(ey)]), batch_size=6,
           epochs=2, shuffle=False, verbose=0,
           callbacks=[_recorder(tcb.Callback, tlog)])
    assert len(tlog) == len(jlog) == 2 * (7 + 1)
    for t, j in zip(tlog, jlog):
        assert t[0] == j[0] and t[-2:] == j[-2:], (t, j)
        assert t[-3] == pytest.approx(j[-3], abs=1e-4)
    res = tm.evaluate(TensorDataset([to_tensor(ex), to_tensor(ey)]),
                      batch_size=6, verbose=0)
    assert res["acc_top1"] == tlog[-1][2]
