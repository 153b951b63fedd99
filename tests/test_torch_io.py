"""``paddle_tpu_torch.io`` against the reference's ``paddle_tpu.io``: the
same datasets and numpy seeds give the same batches, element for element
(exact: both packages only index and stack the same numpy arrays).

- sequential batches, with and without ``drop_last``, over tuple and dict
  samples and an ``IterableDataset``;
- shuffled epochs: ``np.random.seed`` before each loader is built gives
  both the same per-loader seed, so the same order, epoch after epoch;
- the samplers' index streams (``BatchSampler`` over a ``RandomSampler``,
  ``DistributedBatchSampler`` over two ranks, padded and cut) and
  ``random_split``;
- the port's batches keep the numpy dtypes (the reference's int64 arrive
  as int32: JAX runs with x64 off), so values are compared, and dtypes
  against the dataset's own;
- a mid-epoch ``state_dict`` resumed in a fresh loader replays the rest
  of the epoch as the reference's resumed loader does;
- ``fill_ring(K)``: full blocks are the K batches stacked, the epoch tail
  comes back as single batches, and the committed stream state resumes at
  the block boundary;
- the port's own rules: ``num_workers > 0`` gives the batches of
  ``num_workers=0`` (the worker processes' own checks are in
  ``test_torch_io_workers.py``); ``places=None`` means the card and
  raises without one.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x._data)


def _eq(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    else:   # values only: the reference's int64 is int32 (JAX, x64 off)
        np.testing.assert_array_equal(a, b)


def _arrays(n=23):
    rng = np.random.RandomState(0)
    return rng.randn(n, 3).astype(np.float32), \
        rng.randint(0, 5, n).astype(np.int64)


def _loaders(seed=None, **kw):
    x, y = _arrays()
    if seed is not None:
        np.random.seed(seed)
    j = jio.DataLoader(jio.TensorDataset([x, y]), **kw)
    if seed is not None:
        np.random.seed(seed)
    t = tio.DataLoader(tio.TensorDataset([x, y]), places="cpu", **kw)
    return j, t


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("buffered", [False, True])
def test_sequential_batches(drop_last, buffered):
    j, t = _loaders(batch_size=4, drop_last=drop_last,
                    use_buffer_reader=buffered)
    jb, tb = [_np(b) for b in j], [_np(b) for b in t]
    assert len(jb) == len(tb) == len(t) == (5 if drop_last else 6)
    _eq(jb, tb)
    assert [a.dtype for a in tb[0]] == [np.float32, np.int64]


def test_shuffled_epochs_follow_the_numpy_seed():
    j, t = _loaders(seed=7, batch_size=5, shuffle=True)
    for _ in range(3):
        _eq([_np(b) for b in j], [_np(b) for b in t])
    _, t2 = _loaders(seed=8, batch_size=5, shuffle=True)
    _, t3 = _loaders(seed=7, batch_size=5, shuffle=True)
    assert [_np(b)[1].tolist() for b in t2] != \
        [_np(b)[1].tolist() for b in t3]


class _Dicts(jio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return {"x": np.full(2, i, np.float32), "y": np.int64(i % 3)}

    def __len__(self):
        return self.n


class _TDicts(tio.Dataset):
    __getitem__ = _Dicts.__getitem__
    __len__ = _Dicts.__len__

    def __init__(self, n):
        self.n = n


def test_dict_samples_collate_alike():
    j = jio.DataLoader(_Dicts(7), batch_size=3)
    t = tio.DataLoader(_TDicts(7), places="cpu", batch_size=3)
    _eq([_np(b) for b in j], [_np(b) for b in t])


class _Stream(jio.IterableDataset):
    def __iter__(self):
        for i in range(10):
            yield np.arange(3, dtype=np.float32) + i


class _TStream(tio.IterableDataset):
    __iter__ = _Stream.__iter__


def test_iterable_dataset_batches():
    j = jio.DataLoader(_Stream(), batch_size=4)
    t = tio.DataLoader(_TStream(), places="cpu", batch_size=4)
    _eq([_np(b) for b in j], [_np(b) for b in t])
    with pytest.raises(TypeError):
        t.state_dict()


def test_samplers_and_split_match():
    x, _ = _arrays(17)
    for seed in (0, 3):
        np.random.seed(seed)
        jb = list(jio.BatchSampler(jio.TensorDataset([x]), shuffle=True,
                                   batch_size=4))
        np.random.seed(seed)
        tb = list(tio.BatchSampler(tio.TensorDataset([x]), shuffle=True,
                                   batch_size=4))
        assert jb == tb
    for drop_last in (False, True):
        for rank in (0, 1):
            kw = dict(batch_size=3, num_replicas=2, rank=rank, shuffle=True,
                      drop_last=drop_last)
            js = jio.DistributedBatchSampler(jio.TensorDataset([x]), **kw)
            ts = tio.DistributedBatchSampler(tio.TensorDataset([x]), **kw)
            for epoch in (0, 1):
                js.set_epoch(epoch)
                ts.set_epoch(epoch)
                assert list(js) == list(ts) and len(js) == len(ts)
    np.random.seed(5)
    js = jio.random_split(jio.TensorDataset([x]), [10, 7])
    np.random.seed(5)
    ts = tio.random_split(tio.TensorDataset([x]), [10, 7])
    assert [s.indices for s in js] == [s.indices for s in ts]


@pytest.mark.parametrize("taken", [1, 2, 5])
def test_mid_epoch_resume_matches_reference(taken):
    j, t = _loaders(seed=11, batch_size=4, shuffle=True)
    jit_, tit = iter(j), iter(t)
    for _ in range(taken):
        _eq(_np(next(jit_)), _np(next(tit)))
    jsd, tsd = j.state_dict(), t.state_dict()
    assert jsd == tsd
    j2, t2 = _loaders(seed=99, batch_size=4, shuffle=True)
    j2.load_state_dict(jsd)
    t2.load_state_dict(tsd)
    jrest, trest = [_np(b) for b in j2], [_np(b) for b in t2]
    assert len(trest) == len(t) - taken
    _eq(jrest, trest)
    _eq([_np(b) for b in jit_], trest)       # the rest the first one gives
    _eq([_np(b) for b in j2], [_np(b) for b in t2])   # the next epoch


def test_resume_refuses_another_dataset():
    _, t = _loaders(batch_size=4)
    sd = t.state_dict()
    other = tio.DataLoader(tio.TensorDataset([np.zeros((5, 3))]),
                           places="cpu", batch_size=4)
    with pytest.raises(ValueError, match="dataset length changed"):
        other.load_state_dict(sd)


def test_fill_ring_blocks_tail_and_commit():
    kw = dict(batch_size=4, shuffle=True, drop_last=True)   # 5 batches
    j, t = _loaders(seed=4, **kw)
    jblocks, tblocks = list(j.fill_ring(2)), list(t.fill_ring(2))
    assert [b.size for b in tblocks] == [b.size for b in jblocks] \
        == [2, 2, 1]
    for jb, tb in zip(jblocks, tblocks):
        if tb.stacked is None:    # the K-misaligned tail: plain batches
            _eq(_np(jb.batches), _np(tb.batches))
        else:
            _eq(_np(jb.stacked), _np(tb.stacked))
            assert tb.stacked[0].shape == (2, 4, 3)
        assert jb.stream_state == tb.stream_state
    # the public state is the committed one, not the prefetch cursor
    _, t3 = _loaders(seed=4, **kw)
    blocks = list(t3.fill_ring(4))
    assert [b.size for b in blocks] == [4, 1]
    assert t3.state_dict()["batch"] == 0
    t3._commit_stream_state(blocks[0].stream_state)
    assert t3.state_dict()["batch"] == 4
    _, t4 = _loaders(seed=123, **kw)
    t4.load_state_dict(t3.state_dict())
    _eq([_np(b) for b in t4], _np(blocks[1].batches))


def test_workers_and_device_rules():
    x, y = _arrays()
    batches = []
    for workers in (0, 2):
        loader = tio.DataLoader(tio.TensorDataset([x, y]), places="cpu",
                                batch_size=4, num_workers=workers,
                                timeout=120)
        batches.append([_np(b) for b in loader])
        assert loader._pool is None          # shut down after the epoch
    for a, b in zip(*batches):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tio.DataLoader(tio.TensorDataset([x, y]))
