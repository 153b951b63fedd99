"""The port's AMP debugging tools (``amp.debugging``,
``amp.accuracy_compare``) against the JAX package's.

- Operator stats: the call count of every op name the port's choke point
  hooks equals the reference's count for the same name over a Llama-tiny
  forward and loss (float32, and under O1); the span hook in place before
  comes back after.
- The tensor checker (``FLAGS_check_nan_inf``) raises
  ``FloatingPointError`` on an op whose output holds a NaN or an Inf, and
  lets the same op pass once disabled; ``check_numerics`` returns the
  reference's ``(num_nan, num_inf)`` for a finite tensor and raises
  ``FloatingPointError`` where the reference does.
- ``accuracy_compare``: the port's ``tensor_info.jsonl`` dumps of a float32
  and an O1 run of the Llama-tiny forward load in the reference's reader,
  the reference's ``compare_accuracy`` and the port's give the same report
  (the same rows, the same JSON file) on them, and the port's dump has the
  reference's keys and dtypes, its statistics within 1e-4 relative of the
  reference's own dump of the same run (float32: the sums run in another
  order).
- ``debugging.compare_accuracy`` over ``.npz`` dumps gives the reference's
  rows.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import accuracy_compare as jac
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.amp import accuracy_compare as tac
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict)
from paddle_tpu_torch.ops import dispatcher
from paddle_tpu_torch.ops.kernels import nn as tnn

HOOKED = {"embedding", "rms_norm", "linear", "rope", "flash_attention",
          "swiglu", "fused_softmax_ce", "mean"}


@pytest.fixture(autouse=True)
def _no_tp():
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(saved)
    tflags.set_flags({"check_nan_inf": False})


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JModel(JConfig(**dataclasses.asdict(JConfig.tiny())))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(0).randint(0, 256, (2, 128)) \
        .astype(np.int32)
    return jm, tm, ids


def _jrun(jm, ids):
    JCrit()(jm(Tensor(ids)), Tensor(ids))


def _trun(tm, ids):
    t = torch.from_numpy(ids)
    with torch.no_grad():
        LlamaPretrainingCriterion()(tm(t), t)


@pytest.mark.parametrize("level", [None, "O1"])
def test_op_stats_equal_reference_for_hooked_names(models, level):
    jm, tm, ids = models
    outer = object()

    def span(name):
        return outer

    dispatcher.set_op_span_hook(span)
    try:
        tdbg.enable_operator_stats_collection()
        with tamp.auto_cast(enable=level is not None, level=level or "O1"):
            _trun(tm, ids)
        got = tdbg.disable_operator_stats_collection()
        assert dispatcher._OP_SPAN_HOOK is span   # the earlier hook back
    finally:
        dispatcher.set_op_span_hook(None)
    with jdbg.collect_operator_stats():
        with paddle.amp.auto_cast(enable=level is not None,
                                  level=level or "O1"):
            _jrun(jm, ids)
        want = dict(jdbg._op_stats)
    assert set(got) == HOOKED
    assert {k: v["calls"] for k, v in got.items()} == \
        {k: want[k]["calls"] for k in HOOKED}


def test_tensor_checker_raises_on_nan_and_inf():
    x = torch.tensor([[float("nan"), 1.0]])
    w = torch.ones(2, 2)
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(enable=True))
    try:
        assert tflags.get_flag("check_nan_inf")
        with pytest.raises(FloatingPointError, match="'linear'"):
            tnn.linear(x, w)
        with pytest.raises(FloatingPointError, match="'rms_norm'"):
            tnn.rms_norm(torch.tensor([[float("inf"), 1.0]]), None)
        tnn.linear(torch.ones(1, 2), w)               # finite: passes
    finally:
        tdbg.disable_tensor_checker()
    assert not tflags.get_flag("check_nan_inf")
    assert torch.isnan(tnn.linear(x, w)).any()        # off: no check
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(enable=False))
    assert not tflags.get_flag("check_nan_inf")


def test_check_numerics_matches_reference():
    ok = np.ones(3, np.float32)
    assert tdbg.check_numerics(torch.from_numpy(ok)) == \
        jdbg.check_numerics(Tensor(ok)) == (0, 0)
    bad = np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)
    with pytest.raises(FloatingPointError, match="1 NaN / 2 Inf"):
        tdbg.check_numerics(torch.from_numpy(bad), "op", "x")
    with pytest.raises(FloatingPointError, match="1 NaN / 2 Inf"):
        jdbg.check_numerics(Tensor(bad), "op", "x")


def test_compare_accuracy_gives_reference_report(models, tmp_path):
    jm, tm, ids = models
    d32, dlow = str(tmp_path / "fp32"), str(tmp_path / "low")
    with tac.collect_tensor_infos(d32) as infos:
        _trun(tm, ids)
    with tamp.auto_cast(level="O1"), tac.collect_tensor_infos(dlow):
        _trun(tm, ids)
    with jac.collect_tensor_infos(str(tmp_path / "ref")) as jinfos:
        _jrun(jm, ids)
    assert jac._load_run(d32).keys() == tac._load_run(d32).keys()
    want = jac.compare_accuracy(d32, dlow, str(tmp_path / "j.json"),
                                dump_all_tensors=True)
    got = tac.compare_accuracy(d32, dlow, str(tmp_path / "t.json"),
                               dump_all_tensors=True)
    assert got == want and len(got) == len(infos)
    assert json.load(open(tmp_path / "t.json")) == \
        json.load(open(tmp_path / "j.json"))
    assert {r["grade"] for r in got} <= {"ok", "diverged"}
    lin = [r for r in got if r["tensor"].startswith("linear")]
    assert lin and all(r["low"]["dtype"] == "bfloat16"
                       and r["fp32"]["dtype"] == "float32" for r in lin)
    assert tac.compare_accuracy(d32, dlow, str(tmp_path / "u.json")) == \
        jac.compare_accuracy(d32, dlow, str(tmp_path / "v.json"))
    ref = {i.key: i for i in jinfos if i.op_type in HOOKED}
    assert ref.keys() == {i.key for i in infos}
    for i in infos:
        r = ref[i.key]
        assert (i.dtype, i.numel, i.num_nan, i.num_inf) == \
            (r.dtype, r.numel, r.num_nan, r.num_inf)
        for f in ("max_value", "min_value", "mean_value"):
            a, b = getattr(i, f), getattr(r, f)
            assert abs(a - b) <= 1e-4 * max(abs(b), 1.0), (i.key, f, a, b)


def test_npz_compare_accuracy_matches_reference(tmp_path):
    np.savez(tmp_path / "a.npz", w=np.ones(4, np.float32),
             v=np.arange(3, dtype=np.float32), s=np.zeros((2, 2)))
    np.savez(tmp_path / "b.npz", w=np.ones(4, np.float32) * 1.01,
             v=np.array([0, np.nan, 2], np.float32), s=np.zeros(3))
    args = [str(tmp_path / "a.npz"), str(tmp_path / "b.npz")]
    got = tdbg.compare_accuracy(*args, str(tmp_path / "t.json"))
    want = jdbg.compare_accuracy(*args, str(tmp_path / "j.json"))
    assert json.dumps(got) == json.dumps(want) and len(got) == 3
