"""This process's place in the job: rank, world size and local rank.

Counterpart of ``paddle_tpu/distributed/env.py``. The launcher
(``distributed/launch``) sets ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM`` and ``PADDLE_LOCAL_RANK``; torchrun's ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` are read where those are absent. A
process started by neither is rank 0 of a world of 1.
"""

from __future__ import annotations

import os


def _read(paddle_name: str, torch_name: str, default: int) -> int:
    return int(os.environ.get(paddle_name,
                              os.environ.get(torch_name, default)))


def get_rank() -> int:
    return _read("PADDLE_TRAINER_ID", "RANK", 0)


def get_world_size() -> int:
    return _read("PADDLE_TRAINERS_NUM", "WORLD_SIZE", 1)


def get_local_rank() -> int:
    return _read("PADDLE_LOCAL_RANK", "LOCAL_RANK", 0)
