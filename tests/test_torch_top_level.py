"""The port's top-level ``flops``, ``summary``, ``Model``, ``callbacks``,
``device`` and ``quantization`` against the JAX package's, and what
remains of the difference of ``dir()``.

``flops``: the port counts with torch's ``FlopCounterMode`` (matrix
products and convolutions, 2 FLOPs a multiply-add, nothing elementwise),
the reference reads XLA's cost analysis of the compiled forward. Measured
on the CPU (jax 0.9, torch 2.13): LeNet at 28 x 28 682,512 (port) vs
689,560 (reference), a ratio reference / port of 1.010; ``resnet18`` at
32 x 32 74,033,152 vs 43,507,712, a ratio of 0.588 (XLA's count of the
convolutions is below 2 FLOPs a multiply-add there). The test holds the
port's counts to the multiply-adds counted by hand for LeNet and the
ratio to the band [0.55, 1.05]. ``summary``'s parameter counts equal the
reference's exactly.
"""

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.vision import models as rmodels
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.vision import models as tmodels

FLOPS_BAND = (0.55, 1.05)      # reference / port, measured 0.588 and 1.010

# the names the port still lacks: A8's collectives and sharded layers and
# the reference's TPU, JAX and static-graph plumbing (``utils`` came with
# the commit protocol of serving resilience)
STILL_MISSING = {
    "DataParallel", "TPUPlace", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allreduce_sum", "c_broadcast", "create_parameter",
    "dataset", "disable_static", "distribution", "enable_static", "hub",
    "incubate", "inference", "is_compiled_with_tpu", "jax_compat", "moe_ffn",
    "native", "onnx", "profiler", "ring_attention", "static",
    "sync_batch_norm"}


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


@pytest.fixture(scope="module")
def nets():
    set_device("cpu")
    try:
        return {name: (getattr(rmodels, name)(**kw),
                       getattr(tmodels, name)(**kw), shape)
                for name, kw, shape in (
                    ("LeNet", {}, (1, 1, 28, 28)),
                    ("resnet18", dict(num_classes=10), (1, 3, 32, 32)))}
    finally:
        set_device(None)


def test_flops_within_the_measured_band(nets):
    counts = {}
    for name, (rnet, tnet, shape) in nets.items():
        want = paddle_tpu.flops(rnet, input_size=shape)
        got = paddle_tpu_torch.flops(tnet, input_size=shape)
        counts[name] = (got, want)
        assert FLOPS_BAND[0] <= want / got <= FLOPS_BAND[1], (name, got,
                                                               want)
    # LeNet's multiply-adds: conv 1->6 3x3 over 28x28, conv 6->16 5x5
    # over 10x10, then 400->120->84->10
    macs = 6 * 28 * 28 * 9 + 16 * 10 * 10 * 150 + 400 * 120 + 120 * 84 + \
        84 * 10
    assert counts["LeNet"][0] == 2 * macs


def test_flops_takes_inputs_and_keeps_the_mode(nets):
    import torch
    _, tnet, shape = nets["LeNet"]
    tnet.train()
    n = paddle_tpu_torch.flops(tnet, inputs=[np.zeros(shape, np.float32)])
    assert tnet.training
    assert n == paddle_tpu_torch.flops(tnet, input_size=shape)
    assert n == paddle_tpu_torch.flops(tnet, inputs=torch.zeros(shape))
    with pytest.raises(ValueError, match="input_size or inputs"):
        paddle_tpu_torch.flops(tnet)


def test_summary_counts_equal_the_reference(nets, capsys):
    for name, (rnet, tnet, _) in nets.items():
        want = paddle_tpu.summary(rnet)
        got = paddle_tpu_torch.summary(tnet)
        assert got == want, name
    assert "Total params" in capsys.readouterr().out


def test_top_level_names():
    from paddle_tpu_torch import hapi
    assert paddle_tpu_torch.Model is hapi.Model
    assert paddle_tpu_torch.summary is hapi.summary
    assert paddle_tpu_torch.callbacks is hapi.callbacks
    assert paddle_tpu_torch.device.set_device is paddle_tpu_torch.set_device
    assert hasattr(paddle_tpu_torch.callbacks, "EarlyStopping")
    assert {"QAT", "PTQ", "QuantConfig"} <= set(
        paddle_tpu_torch.quantization.__all__)


def _reference_names():
    """``paddle_tpu``'s public names as its import makes them, read in a
    fresh process: in this one, a test that imports a submodule
    (``paddle_tpu.analysis``) adds it to the package's ``dir()``."""
    import json
    import os
    import subprocess
    import sys
    code = ("import json, paddle_tpu; print(json.dumps([n for n in "
            "dir(paddle_tpu) if not n.startswith('_')]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_only_the_listed_names_are_missing():
    mine = {n for n in dir(paddle_tpu_torch) if not n.startswith("_")}
    assert sorted(_reference_names() - mine) == sorted(STILL_MISSING)
