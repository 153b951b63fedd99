"""``io.DataLoader(num_workers > 0)``: the worker processes
(``paddle_tpu_torch.io._WorkerPool``) against the reference's
(``paddle_tpu.io._WorkerPool``), on the CPU.

The same dataset and numpy seed give both packages' ``num_workers=2``
loaders the same batches in the same order (exact: both only index and
stack the same numpy arrays; the reference's int64 arrive as int32),
also for a dataset whose ``__getitem__`` draws from ``np.random`` (each
worker seeds ``base_seed + worker_id``, ``base_seed`` drawn from the
parent's ``np.random`` where the reference draws it) and with a
``worker_init_fn``. Also: a persistent pool over two epochs keeps its
processes (PIDs other than the parent's) and gives the reference's two
epochs; an epoch abandoned mid-way leaves the next one whole; a worker's
exception is raised with its traceback; a worker slower than ``timeout``
raises; a collate_fn that cannot be pickled falls back to fork-started
workers with a warning (in a fresh process: forking this one, which
runs JAX's threads, could deadlock); ``hapi.Model.fit`` over ``num_workers=2`` gives
the losses of ``num_workers=0`` bit for bit. Every loader has a bounded
``timeout`` and its pool is shut down.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_io_datasets as D
import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio

TIMEOUT = 120
ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x._data)


def _loaders(dataset, seed=0, **kw):
    kw = dict(batch_size=4, num_workers=2, timeout=TIMEOUT, **kw)
    np.random.seed(seed)
    tl = tio.DataLoader(dataset, places="cpu", **kw)
    np.random.seed(seed)
    jl = jio.DataLoader(dataset, **kw)
    return tl, jl


def _close(*loaders):
    for dl in loaders:
        if dl._pool is not None:
            dl._pool.shutdown()
            dl._pool = None


def _equal(tb, jb):
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        for u, v in zip(_np(a), _np(b)):
            np.testing.assert_array_equal(u, v.astype(u.dtype))


@pytest.mark.parametrize("dataset,kw", [
    (D.Ranged(), dict(shuffle=True)),
    (D.Ranged(), dict(shuffle=False, drop_last=True)),
    (D.Noisy(), dict(shuffle=True)),
    (D.Noisy(), dict(shuffle=False, worker_init_fn=D.seed_marker)),
], ids=["shuffled", "drop_last", "np_random", "worker_init_fn"])
def test_batches_equal_the_reference(dataset, kw):
    out = []
    for io in (tio, jio):       # seeded alike up to the workers' start
        np.random.seed(0)
        dl = io.DataLoader(dataset, batch_size=4, num_workers=2,
                           timeout=TIMEOUT, **kw,
                           **({"places": "cpu"} if io is tio else {}))
        try:
            out.append(list(dl))
        finally:
            _close(dl)
    _equal(*out)


def test_persistent_pool_over_two_epochs():
    tl, jl = _loaders(D.Pids(), shuffle=True, persistent_workers=True)
    try:
        for epoch in range(2):
            tb, jb = list(tl), list(jl)
            pids = {int(p) for b in tb for p in _np(b)[1]}
            if epoch == 0:
                first = set(tl.worker_pids())
            assert pids == first and len(pids) == 2
            assert os.getpid() not in pids
            for a, b in zip(tb, jb):
                np.testing.assert_array_equal(_np(a)[0], _np(b)[0])
    finally:
        _close(tl, jl)


def test_abandoned_epoch_leaves_the_next_whole():
    tl, jl = _loaders(D.Ranged(), shuffle=True, persistent_workers=True)
    try:
        for dl in (tl, jl):
            for i, _ in enumerate(dl):
                if i == 1:
                    break
        _equal(list(tl), list(jl))
        assert len(list(tl)) == len(tl)
    finally:
        _close(tl, jl)


def test_worker_exception_is_raised_with_its_traceback():
    tl = tio.DataLoader(D.Failing(), places="cpu", batch_size=4,
                        num_workers=2, timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="ValueError: bad sample 7"):
        list(tl)
    assert tl._pool is None


def test_slow_worker_times_out():
    tl = tio.DataLoader(D.Slow(4), places="cpu", batch_size=2,
                        num_workers=1, timeout=0.5)
    with pytest.raises(RuntimeError, match="timed out after 0.5s"):
        list(tl)


def test_unpicklable_collate_falls_back_to_fork():
    """In a fresh process (no JAX threads to fork): a lambda collate_fn
    cannot be pickled, so the pool warns and forks its workers."""
    code = (
        "import warnings, numpy as np\n"
        "import _torch_io_datasets as D\n"
        "import paddle_tpu_torch.io as tio\n"
        "collate = lambda batch: np.stack([s[0] for s in batch])\n"
        "dl = tio.DataLoader(D.Ranged(9), places='cpu', batch_size=4,\n"
        "                    num_workers=2, timeout=60, collate_fn=collate)\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    got = [b.numpy()[:, 0].tolist() for b in dl]\n"
        "print(got, any('falling back to fork' in str(x.message)\n"
        "               for x in w))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == \
        "[[0, 1, 2, 3], [4, 5, 6, 7], [8]] True"


def test_model_fit_over_workers_equals_the_thread_path():
    from paddle_tpu_torch.hapi import Model, callbacks
    from paddle_tpu_torch.optimizer import SGD

    def fit(workers):
        losses = []

        class Record(callbacks.ProgBarLogger):
            def on_train_batch_end(self, step, logs=None):
                losses.append(logs["loss"])

        torch.manual_seed(0)
        net = torch.nn.Linear(4, 1)
        m = Model(net)
        m.prepare(SGD(learning_rate=0.05, parameters=net.parameters()),
                  torch.nn.MSELoss())
        np.random.seed(3)
        loader = tio.DataLoader(D.Regression(), places="cpu", batch_size=4,
                                shuffle=True, num_workers=workers,
                                timeout=TIMEOUT, persistent_workers=True)
        try:
            m.fit(loader, epochs=2, verbose=0, callbacks=[Record(verbose=0)])
        finally:
            _close(loader)
        return losses, [p.detach().clone() for p in net.parameters()]

    l0, w0 = fit(0)
    l2, w2 = fit(2)
    assert len(l0) == 12 and l0 == l2
    assert all(torch.equal(a, b) for a, b in zip(w0, w2))
