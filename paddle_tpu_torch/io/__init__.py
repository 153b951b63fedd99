"""paddle.io: datasets, samplers and the DataLoader.

Counterpart of ``paddle_tpu/io/__init__.py``: ``Dataset``,
``IterableDataset``, ``TensorDataset``, ``Subset``, ``random_split``, the
samplers (``SequenceSampler``, ``RandomSampler``,
``DistributedBatchSampler`` with the reference's index math,
``BatchSampler``), ``default_collate_fn`` and ``DataLoader`` with its
prefetch thread (``use_buffer_reader``), the resumable stream
(``state_dict`` / ``load_state_dict``), ``fill_ring(k)``, ``RingBlock`` and
``_commit_stream_state``. The same numpy seed gives the reference's batch
order: shuffles draw from ``np.random`` exactly where the reference draws.

Batches come out as ``torch.Tensor``s on ``places`` (None: the CUDA card,
raising when there is none; pass ``places="cpu"`` for the CPU). For the
card a batch is staged in pinned host memory, so one host-to-device copy
per leaf moves it and the copy runs beside the training step; a ring
block is stacked on the host first, so one copy per leaf fills the whole
``[K, ...]`` block.

``num_workers > 0`` starts worker PROCESSES (the reference's
``_WorkerPool``, :211-330): index batches fan out over per-worker queues,
each worker collates NUMPY batches and sends them back on one result
queue, where they are put back in order by sequence number; messages
carry an epoch tag, so results of an abandoned epoch are dropped;
``persistent_workers`` keeps the pool across epochs; ``timeout`` bounds
each wait for a result; a worker's exception is raised in the parent with
its traceback; each worker seeds ``np.random`` with ``base_seed +
worker_id`` (``base_seed`` drawn from ``np.random`` when the pool
starts) and runs ``worker_init_fn(worker_id)``. A worker never touches
CUDA: the parent makes the tensors and pins them. The start method is
``forkserver`` (a forked copy of a process that has initialised CUDA is
unsafe), so the dataset, ``collate_fn`` and ``worker_init_fn`` must be
picklable, i.e. defined at module level (a script's under ``if __name__ ==
"__main__"``, since the workers import its module); when they are not,
the pool falls back to ``fork`` with a warning, as the reference does.
An ``IterableDataset`` keeps the thread path.
"""

from __future__ import annotations

import atexit
import itertools
import multiprocessing as mp
import pickle
import queue
import threading
import time
import traceback
import warnings
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["BatchSampler", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "RingBlock", "Sampler", "SequenceSampler", "Subset",
           "TensorDataset", "default_collate_fn", "random_split"]


class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


def _numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [_numpy(t) for t in tensors]
        n = arrays[0].shape[0]
        if not all(a.shape[0] == n for a in arrays):
            raise ValueError("TensorDataset: every tensor needs the same "
                             "leading size")
        self.arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self):
        return self.arrays[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    perm = np.random.permutation(n)
    out, ofs = [], 0
    for n_i in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n_i].tolist()))
        ofs += n_i
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


def _dist_world():
    """(world size, rank) of an initialized ``torch.distributed`` group,
    else (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(Sampler):
    """Shards batches across data-parallel ranks: each epoch's order
    (shuffled by ``RandomState(epoch)``), padded by wrapping to a multiple
    of ``batch_size * nranks`` (or cut under ``drop_last``), then rank r
    takes every nranks-th index from r."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        super().__init__(dataset)
        world, me = _dist_world()
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.data_source)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        step = self.batch_size * self.nranks
        if self.drop_last:
            indices = indices[: (n // step) * step]
        else:
            total = int(np.ceil(n / step)) * step
            pad = total - n
            if pad:
                indices = np.concatenate([indices, indices[:pad]])
        shard = indices[self.local_rank::self.nranks]
        for i in range(0, len(shard) - self.batch_size + 1, self.batch_size):
            yield shard[i:i + self.batch_size].tolist()

    def __len__(self):
        n = len(self.data_source)
        step = self.batch_size * self.nranks
        if self.drop_last:
            return n // step
        return int(np.ceil(n / step))


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.sampler = sampler or (RandomSampler(dataset) if shuffle
                                   else SequenceSampler(dataset))
        self.batch_size, self.drop_last = batch_size, drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch: List):
    """Stack samples into numpy batches, as paddle's default collate."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic, int, float)):
        return np.stack([np.asarray(s) for s in batch])
    if isinstance(sample, torch.Tensor):
        return np.stack([_numpy(s) for s in batch])
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([s[i] for s in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return batch


def _worker_loop(dataset, index_q, data_q, collate_fn, init_fn, worker_id,
                 base_seed):
    """A worker process: take ``(epoch, seq, indices)``, collate the
    samples, put ``(epoch, seq, batch, error)`` back; stop at None."""
    np.random.seed((base_seed + worker_id) % (2 ** 31))
    try:
        if init_fn is not None:
            init_fn(worker_id)
        while True:
            item = index_q.get()
            if item is None:
                break
            epoch, seq, idxs = item
            try:
                batch = collate_fn([dataset[i] for i in idxs])
                data_q.put((epoch, seq, batch, None))
            except Exception:
                data_q.put((epoch, seq, None, traceback.format_exc()))
    except KeyboardInterrupt:
        pass


class _WorkerPool:
    """``num_workers`` processes; ``run_epoch`` dispatches ``(seq,
    indices)`` round-robin and yields the collated batches in order."""

    def __init__(self, dataset, collate_fn, num_workers, worker_init_fn,
                 prefetch_factor, timeout):
        self.num_workers = num_workers
        self.timeout = timeout or None
        self.prefetch = prefetch_factor
        self.procs: List = []
        self.index_qs: List = []
        try:
            self._spawn("forkserver", dataset, collate_fn, worker_init_fn)
        except (TypeError, AttributeError, ImportError,
                pickle.PicklingError) as e:
            warnings.warn(
                f"DataLoader dataset/collate_fn/worker_init_fn is not "
                f"picklable ({e}); falling back to fork-started workers "
                f"(unsafe in multithreaded processes). Make them "
                f"module-level to use the forkserver start method.",
                RuntimeWarning)
            self._spawn("fork", dataset, collate_fn, worker_init_fn)
        self._closed = False
        self._epoch = 0
        atexit.register(self.shutdown)

    def _spawn(self, method, dataset, collate_fn, worker_init_fn):
        ctx = mp.get_context(method)
        self.data_q = ctx.Queue()
        self.index_qs = [ctx.Queue() for _ in range(self.num_workers)]
        base_seed = int(np.random.randint(0, 2 ** 31))
        self.procs = []
        for w in range(self.num_workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(dataset, self.index_qs[w], self.data_q, collate_fn,
                      worker_init_fn, w, base_seed),
                daemon=True)
            try:
                p.start()
            except Exception:
                for q in self.procs:
                    q.terminate()
                raise
            self.procs.append(p)

    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def run_epoch(self, index_iter):
        """The collated batches of ``index_iter``, in its order; at most
        ``num_workers * prefetch_factor`` in flight."""
        self._epoch += 1
        epoch = self._epoch
        seq_out, pending = 0, 0
        buffered = {}
        it = iter(enumerate(index_iter))

        def dispatch():
            nonlocal pending
            try:
                seq, idxs = next(it)
            except StopIteration:
                return False
            self.index_qs[seq % self.num_workers].put((epoch, seq, idxs))
            pending += 1
            return True

        for _ in range(self.num_workers * self.prefetch):
            if not dispatch():
                break
        while pending > 0 or seq_out in buffered:
            while seq_out in buffered:
                yield buffered.pop(seq_out)
                seq_out += 1
                dispatch()
            if pending == 0:
                break
            ep, seq, batch, err = self._next_result()
            if ep != epoch:
                continue        # left over from an abandoned epoch
            pending -= 1
            if err is not None:
                self.shutdown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            buffered[seq] = batch

    def _next_result(self):
        """The next message, checking every second that no worker died
        (one that cannot unpickle its dataset exits at once)."""
        waited = 0.0
        while True:
            step = 1.0 if self.timeout is None else \
                min(1.0, self.timeout - waited)
            try:
                return self.data_q.get(timeout=max(step, 0.0))
            except queue.Empty:
                waited += step
            dead = [p for p in self.procs if p.exitcode not in (None, 0)]
            if dead:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker (pid {dead[0].pid}) exited with "
                    f"code {dead[0].exitcode} (a worker that cannot "
                    f"import the dataset's class, e.g. one defined under "
                    f"`if __name__ == '__main__'`, exits at once)")
            if self.timeout is not None and waited >= self.timeout:
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker timed out after {self.timeout}s")

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.shutdown)
        for q in self.index_qs:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass    # the worker is gone: the join below reaps it
        # drain the results while the workers exit: a worker whose
        # results are still buffered cannot finish before they are read
        deadline = time.monotonic() + 5.0
        while any(p.is_alive() for p in self.procs) \
                and time.monotonic() < deadline:
            try:
                self.data_q.get(timeout=0.05)
            except queue.Empty:
                pass
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
        for q in self.index_qs:
            q.cancel_join_thread()     # undelivered indices are moot
            q.close()
        self.data_q.close()


class DataLoader:
    """Batching loader with a RESUMABLE stream: :meth:`state_dict` /
    :meth:`load_state_dict` hold (epoch, batch cursor, sampler seed), so a
    resumed run replays the exact remaining batches. When the loader owns
    its sampler (``batch_sampler=None``), each epoch's shuffle derives
    from a per-loader seed (drawn from ``np.random`` at construction) and
    the epoch number; a custom ``batch_sampler`` must itself be
    deterministic per epoch for the cursor skip to replay the same
    indices."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 timeout=0, worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.device = resolve_device(places)
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._pool: Optional[_WorkerPool] = None
        if int(prefetch_factor) < 1:
            raise ValueError(
                f"prefetch_factor must be >= 1, got {prefetch_factor} "
                f"(1 = single batch in flight, larger values deepen the "
                f"prefetch queue)")
        self.prefetch_factor = int(prefetch_factor)
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.shuffle = bool(shuffle)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._epoch = -1
        self._cursor = 0
        self._resume = False
        self._seed = int(np.random.randint(0, 2 ** 31))
        # ring mode (fill_ring): the prefetch thread's live cursor runs
        # ahead of training by whole blocks, so the public stream state
        # is pinned to the last COMMITTED block boundary
        self._ring_state: Optional[dict] = None
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
            self.num_workers = 0   # a stream stays on the thread path
            self._owns_sampler = False
        else:
            self._owns_sampler = batch_sampler is None
            self.batch_sampler = batch_sampler or BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown()

    def worker_pids(self) -> List[int]:
        """The live worker processes' PIDs (empty without a pool)."""
        return [] if self._pool is None or self._pool._closed \
            else self._pool.pids()

    def _iter_multiprocess(self, idx_iter):
        if self._pool is None or self._pool._closed:
            self._pool = _WorkerPool(self.dataset, self.collate_fn,
                                     self.num_workers, self.worker_init_fn,
                                     self.prefetch_factor, self.timeout)
        pool = self._pool
        try:
            yield from pool.run_epoch(idx_iter)
        finally:
            if not self.persistent_workers:
                pool.shutdown()
                self._pool = None

    # -- resumable-stream state ----------------------------------------------
    def state_dict(self) -> dict:
        """The stream position: a fresh loader resumed from it replays the
        remaining batches exactly."""
        if isinstance(self.dataset, IterableDataset):
            raise TypeError(
                "IterableDataset streams are not resumable: the loader "
                "cannot re-derive an arbitrary position in user iterator "
                "state; checkpoint the stream inside the dataset instead")
        if self._ring_state is not None:
            return dict(self._ring_state)
        return self._live_state()

    def _live_state(self) -> dict:
        return {"epoch": self._epoch, "batch": self._cursor,
                "seed": self._seed, "dataset_len": len(self.dataset),
                "owns_sampler": self._owns_sampler}

    def load_state_dict(self, sd: dict) -> None:
        if isinstance(self.dataset, IterableDataset):
            raise TypeError("IterableDataset streams are not resumable")
        have, saved = len(self.dataset), int(sd["dataset_len"])
        if saved != have:
            raise ValueError(
                f"DataLoader.load_state_dict: dataset length changed "
                f"({saved} samples at save time, {have} now): the saved "
                f"cursor would replay different data; refusing")
        saved_owns = bool(sd.get("owns_sampler", self._owns_sampler))
        if saved_owns != self._owns_sampler:
            raise ValueError(
                "DataLoader.load_state_dict: sampler arrangement changed "
                "(one loader owns its sampler, the other uses a custom "
                "batch_sampler): construct the loader the way the saving "
                "run did")
        self._epoch = int(sd["epoch"])
        self._cursor = int(sd["batch"])
        self._seed = int(sd["seed"])
        self._resume = True
        self._ring_state = None

    def _index_batches(self, epoch: int):
        """The deterministic index-batch stream of ``epoch``."""
        if self._owns_sampler:
            n = len(self.dataset)
            if self.shuffle:
                rng = np.random.RandomState(
                    (self._seed + 0x9E3779B1 * epoch) % (2 ** 31 - 1))
                order = rng.permutation(n)
            else:
                order = np.arange(n)
            bs = self.batch_size
            end = (n // bs) * bs if self.drop_last else n
            for i in range(0, end, bs):
                yield order[i:i + bs].tolist()
        else:
            yield from iter(self.batch_sampler)

    def _produce_iterable(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _buffered(self, src):
        """Bounded background prefetch: ``src`` runs on a thread (the
        host-to-device copies too), ``prefetch_factor`` items ahead."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        error: List[BaseException] = []

        def worker():
            try:
                for item in src:
                    q.put(item)
            except BaseException as e:   # handed to the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                break
            yield item

    def _epoch_batches(self):
        """One resumable map-style pass of collated numpy batches; the
        caller counts the cursor."""
        if self._resume:
            self._resume = False
            start = self._cursor
        else:
            self._epoch += 1
            start = 0
        self._cursor = start
        idx_iter = self._index_batches(self._epoch)
        if start:
            idx_iter = itertools.islice(idx_iter, start, None)
        if self.num_workers > 0:
            yield from self._iter_multiprocess(idx_iter)
            return
        for idxs in idx_iter:
            yield self.collate_fn([self.dataset[i] for i in idxs])

    def _tensors(self, batch):
        return _to_tensors(batch, self.device)

    def __iter__(self):
        if isinstance(self.dataset, IterableDataset):
            src = (self._tensors(b) for b in self._produce_iterable())
            if self.use_buffer_reader:
                src = self._buffered(src)
            yield from src
            return
        src = (self._tensors(b) for b in self._epoch_batches())
        if self.use_buffer_reader and self.num_workers == 0:
            src = self._buffered(src)
        for b in src:
            # counted as consumed BEFORE it is handed out: a state_dict
            # taken between yields resumes after this batch
            self._cursor += 1
            yield b

    # -- the input ring of multi-step capture ----------------------------------
    def fill_ring(self, k: int):
        """The epoch in ``[K, ...]``-stacked :class:`RingBlock`\\ s for
        multi-step capture (``jit_step(fn, k_steps=K)``), stacked and
        moved by the prefetch thread. The epoch's K-misaligned tail comes
        back as size-1 blocks of plain ``batches``. Each block carries the
        stream state after its last draw; the training loop commits it
        (:meth:`_commit_stream_state`) once the block has trained, which
        pins :meth:`state_dict` to the last committed block."""
        if isinstance(self.dataset, IterableDataset):
            raise TypeError(
                "fill_ring needs a resumable map-style stream: an "
                "IterableDataset cannot re-derive a block boundary")
        k = int(k)
        if k < 1:
            raise ValueError(f"fill_ring: k must be >= 1, got {k}")
        if self._ring_state is None:
            self._ring_state = self._live_state()
        gen = self._ring_blocks(k)
        if self.use_buffer_reader:
            gen = self._buffered(gen)
        return gen

    def _ring_blocks(self, k: int):
        buf: List[tuple] = []
        for b in self._epoch_batches():
            self._cursor += 1           # producer side: drawn into the ring
            buf.append((b, self._live_state()))
            if len(buf) == k:
                yield RingBlock(self._tensors(_stack_batches(
                    [x for x, _ in buf])), None, buf[-1][1], k)
                buf = []
        for b, st in buf:               # the K-misaligned epoch tail
            yield RingBlock(None, [self._tensors(b)], st, 1)

    def _commit_stream_state(self, sd: dict) -> None:
        """Mark a ring block's batches as trained: ``state_dict`` resumes
        after them."""
        self._ring_state = dict(sd)


class RingBlock:
    """One K-step slab of the input ring: a ``stacked`` batch tree
    (leading axis = step) for the multi-step graph, or, for the epoch
    tail, unstacked ``batches`` for single-step capture.
    ``stream_state`` is the loader's position after the block's last
    draw."""

    __slots__ = ("stacked", "batches", "stream_state", "size")

    def __init__(self, stacked, batches, stream_state, size):
        self.stacked = stacked
        self.batches = batches
        self.stream_state = stream_state
        self.size = size


def _stack_batches(batches: List):
    """K collated batch trees stacked along a new leading step axis."""
    b0 = batches[0]
    if isinstance(b0, np.ndarray):
        return np.stack(batches)
    if isinstance(b0, (tuple, list)):
        return [_stack_batches([b[i] for b in batches])
                for i in range(len(b0))]
    if isinstance(b0, dict):
        return {key: _stack_batches([b[key] for b in batches]) for key in b0}
    return np.stack([np.asarray(b) for b in batches])


def _to_tensors(batch, device: torch.device) -> Any:
    """A collated numpy tree as tensors on ``device``; for the card each
    array goes through pinned memory, one asynchronous copy."""
    if isinstance(batch, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if device.type == "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)
    if isinstance(batch, (tuple, list)):
        return [_to_tensors(b, device) for b in batch]
    if isinstance(batch, dict):
        return {k: _to_tensors(v, device) for k, v in batch.items()}
    return batch
