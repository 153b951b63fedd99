"""Datasets for ``test_torch_io_workers.py``, at module level (and with
no JAX import) so that the DataLoaders' forkserver workers can import
them."""

import os
import time

import numpy as np


class Ranged:
    """Sample i: an int64 row of i's and a float32 row of i / 10."""

    def __init__(self, n=23):
        self.n = n

    def __getitem__(self, i):
        return (np.full((3,), i, np.int64),
                np.full((2,), i / 10.0, np.float32))

    def __len__(self):
        return self.n


class Noisy(Ranged):
    """Sample i plus a draw from the worker's ``np.random``."""

    def __getitem__(self, i):
        return (np.full((3,), i, np.int64),
                np.random.rand(2).astype(np.float32))


class Pids(Ranged):
    """Sample i and the pid of the process that loaded it."""

    def __getitem__(self, i):
        return np.int64(i), np.int64(os.getpid())


class Failing(Ranged):
    def __getitem__(self, i):
        if i == 7:
            raise ValueError("bad sample 7")
        return super().__getitem__(i)


class Slow(Ranged):
    def __getitem__(self, i):
        time.sleep(3.0)
        return super().__getitem__(i)


class Regression:
    """x ``[4]`` float32 from a seeded table, y = x @ w + noise."""

    def __init__(self, n=24):
        rng = np.random.RandomState(11)
        self.x = rng.randn(n, 4).astype(np.float32)
        self.y = (self.x @ rng.randn(4, 1) + 0.1 * rng.randn(n, 1)) \
            .astype(np.float32)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def seed_marker(worker_id):
    """A worker_init_fn: offsets the worker's np.random stream."""
    np.random.seed(1000 + worker_id)
