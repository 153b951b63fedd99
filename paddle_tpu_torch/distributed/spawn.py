"""``paddle.distributed.spawn``: start ``nprocs`` processes of a function.

Counterpart of ``spawn`` in ``paddle_tpu/distributed/__init__.py``
(:48-51), where a single controller makes it a direct call. Here it
starts real processes (``torch.multiprocessing``, the ``spawn`` start
method): process i runs ``func(*args)`` with the launcher's variables set
(``PADDLE_TRAINER_ID`` = ``RANK`` = i, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` of a free local
port), so ``init_parallel_env`` joins them. ``nprocs=-1`` means one
process per visible card (one on a machine without one). ``func`` must be
importable by name (a module-level function). With ``join`` the call
returns when all have exited and raises if one failed; without, it
returns the ``ProcessContext``.
"""

from __future__ import annotations

import os

import torch
import torch.multiprocessing as mp


def _entry(i: int, func, args, envs) -> None:
    os.environ.update(envs[i])
    func(*args)


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options):
    from .collective import _free_port
    if nprocs < 0:
        nprocs = max(torch.cuda.device_count(), 1) \
            if torch.cuda.is_available() else 1
    port = str(_free_port())
    envs = [{"PADDLE_TRAINER_ID": str(i), "RANK": str(i),
             "PADDLE_TRAINERS_NUM": str(nprocs), "WORLD_SIZE": str(nprocs),
             "PADDLE_LOCAL_RANK": str(i), "LOCAL_RANK": str(i),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
            for i in range(nprocs)]
    return mp.start_processes(_entry, args=(func, tuple(args), envs),
                              nprocs=nprocs, join=join, daemon=daemon,
                              start_method="spawn")
