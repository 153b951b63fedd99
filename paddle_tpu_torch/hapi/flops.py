"""``paddle.flops``: a network's forward FLOPs.

Counterpart of ``paddle_tpu/hapi/flops.py:17``, which reads XLA's cost
analysis of the compiled forward. Torch has no such analysis: here
``torch.utils.flop_counter.FlopCounterMode`` counts the forward run once
in eval mode under ``no_grad``. It counts the matrix products and
convolutions (2 FLOPs a multiply-add) and nothing elementwise, where XLA
also counts the elementwise work (activations, norms, pools, adds), so
the two counts differ by a model's share of elementwise work (measured on
LeNet and ``resnet18`` at 32 x 32 in ``tests/test_torch_top_level.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _device(net: torch.nn.Module) -> torch.device:
    for p in net.parameters():
        return p.device
    from ..core.device import layer_device
    return layer_device()


def flops(net: torch.nn.Module, input_size: Optional[Sequence[int]] = None,
          inputs=None, custom_ops=None, print_detail: bool = False) -> int:
    """Total forward FLOPs of ``net`` on float32 zeros of ``input_size``
    or on ``inputs`` (a tensor or array, or a list of them: needed for a
    model of several inputs or of integer inputs), on the net's device.
    ``custom_ops`` maps torch ops to FLOP formulas
    (``FlopCounterMode``'s ``custom_mapping``); ``print_detail`` prints
    the total and the count by module."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = _device(net)
    if inputs is not None:
        seq = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        xs = [torch.as_tensor(a if isinstance(a, torch.Tensor)
                              else np.asarray(a)).to(dev) for a in seq]
    elif input_size is not None:
        xs = [torch.zeros(tuple(input_size), dtype=torch.float32,
                          device=dev)]
    else:
        raise ValueError("flops: provide input_size or inputs")
    was_training = net.training
    net.eval()
    try:
        counter = FlopCounterMode(display=bool(print_detail),
                                  custom_mapping=custom_ops or {})
        with torch.no_grad(), counter:
            net(*xs)
        total = int(counter.get_total_flops())
    finally:
        if was_training:
            net.train()
    if print_detail:
        print(f"Total FLOPs: {total:,}")
    return total
