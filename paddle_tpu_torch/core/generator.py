"""The port's random generators, one per device.

Counterpart of ``paddle_tpu/core/generator.py`` and of the rng-state
functions of ``paddle_tpu/tensor_api.py:349-372``. The reference keeps one
threefry key that every random op splits; the port keeps one
``torch.Generator`` per device, which every random op, initializer and
dropout mask draws from (never from torch's global generator), so
``torch.manual_seed`` changes none of the port's draws. :func:`seed`
reseeds them all, and numpy's global generator too, which the
DataLoaders' shuffles draw from. Under step capture the generator for the
card is registered with every graph (``jit/step_capture.py``), so a
replayed draw advances it as the eager draw does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device

_SEED = [0]
_GENERATORS: Dict[str, torch.Generator] = {}


def _key(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def seed(s: int) -> None:
    """Reseed the port's per-device generators and numpy's global one (the
    reference's ``paddle.seed``): every later default draw, and every
    later DataLoader shuffle, starts from ``s``."""
    _SEED[0] = int(s)
    _GENERATORS.clear()
    np.random.seed(int(s) % 2 ** 32)


def default_generator(device: DeviceLike = None) -> torch.Generator:
    """The port's generator for ``device`` (None: ``set_device``'s device,
    the card by default), seeded from :func:`seed`."""
    from .device import get_device
    dev = _key(resolve_device(device if device is not None
                              else get_device()))
    key = str(dev)
    g = _GENERATORS.get(key)
    if g is None:
        g = torch.Generator(device=dev).manual_seed(_SEED[0])
        _GENERATORS[key] = g
    return g


def get_rng_state(device: DeviceLike = None) -> List[torch.Tensor]:
    """The state of the generator for ``device``, as a one-element list
    (the reference's ``get_rng_state``)."""
    return [default_generator(device).get_state()]


def set_rng_state(state_list, device: DeviceLike = None) -> None:
    states = list(state_list)
    if len(states) != 1:
        raise ValueError(f"Length of rng state list should be 1, but got "
                         f"{len(states)}")
    default_generator(device).set_state(states[0])


def get_cuda_rng_state() -> List[torch.Tensor]:
    """The states of the port's generators for every CUDA card."""
    return [default_generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list) -> None:
    states = list(state_list)
    if len(states) != torch.cuda.device_count():
        raise ValueError(f"Length of cuda rng state list should be "
                         f"{torch.cuda.device_count()}, but got "
                         f"{len(states)}")
    for i, s in enumerate(states):
        default_generator(torch.device("cuda", i)).set_state(s)


def generator_for(device, generator: Optional[torch.Generator] = None
                  ) -> torch.Generator:
    """``generator`` if given, else the port's generator for ``device``."""
    return generator if generator is not None else default_generator(device)
