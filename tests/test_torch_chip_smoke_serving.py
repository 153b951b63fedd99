"""``chip_smoke.py``'s gang-engine, contiguous-cache and serving-series
phases, rehearsed on the CPU at a tiny size (a 2-layer bf16 Llama,
prompts of 12-60 tokens): ``serve``'s registry series, spans and tallies with ``check_serving_metrics`` (which
passes the run and refuses a series that misses a tally, a missing step
span, or a series recorded with metrics and tracing off);
``phase_serve_gang`` (the gang engine's tokens against the ragged
engine's under ``flip_check``, its launches a step, its sampled
gang-decode calls against the plain versions, every decode step's logits
of two requests against the prefill path); ``flip_check`` itself (no
flip, a planted flip, one over the margin limit);
``decode_logits_check`` refusing a row taken from another request or
another step; ``recorder_cost`` (the flight recorder on for odd steps
only); and
``phase_generate_contiguous`` with the script's ``"cuda"`` read as
``"cpu"``. On the CPU the kernels' plain versions run: a wrapper here adds
the launch the card would count."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (ContinuousBatchingEngine, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa

ROOT = Path(__file__).resolve().parents[1]


def _smoke(on_cpu=False):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_serving_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    if not on_cpu:
        spec.loader.exec_module(mod)
        return mod
    src = (ROOT / "chip_smoke.py").read_text()
    src = src.replace(".cuda()", ".cpu()").replace('device="cuda"',
                                                   'device="cpu"')
    mod.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


@pytest.fixture
def card_free(monkeypatch):
    """The torch.cuda calls the phases make, as no-ops; the kernels'
    wrappers counting the launch the card would make."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(pa, "sm_count", lambda device: 132)
    for mod, name, counter in ((pa, "paged_attention", pa.launches),
                               (rpa, "ragged_paged_attention",
                                rpa.launches)):
        real = getattr(mod, name)

        def bumped(*a, _real=real, _c=counter, **k):
            _c.add()
            return _real(*a, **k)
        bumped.__name__ = name
        monkeypatch.setattr(mod, name, bumped)


@pytest.fixture(scope="module")
def model():
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=160,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      dtype="bfloat16")
    return LlamaForCausalLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def _prompts(n=16, lo=12, hi=60, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, int(m)).astype(np.int32)
            for m in rng.randint(lo, hi, n)]


def _ragged(model, prompts, new, kv):
    eng = ContinuousBatchingEngine(model, max_batch=16, num_blocks=64,
                                   block_size=64, temperature=0.0,
                                   kv_dtype=kv)
    for p in prompts:
        eng.add_request(p, max_new_tokens=new)
    return eng.run()


def test_flip_check_counts_and_refuses(model, monkeypatch):
    cs = _smoke()
    prompts = _prompts(3, seed=1)
    want = [list(v) for v in _ragged(model, prompts, 6, "bf16").values()]
    res = cs.flip_check(torch, model, prompts, want, want, "bf16")
    assert (res["flips"], res["compared_tokens"]) == (0, 18)
    bad = [list(w) for w in want]
    bad[1][2] = (bad[1][2] + 1) % 128
    bad[1][4] = (bad[1][4] + 1) % 128          # after the flip: not read
    res = cs.flip_check(torch, model, prompts, bad, want, "bf16")
    assert [(f["request"], f["position"]) for f in res["detail"]] == [(1, 2)]
    assert res["compared_tokens"] == 6 + 3 + 6
    monkeypatch.setattr(cs, "FLIP_MARGIN_MAX", 0.0)
    with pytest.raises(AssertionError, match="flips at logit margin"):
        cs.flip_check(torch, model, prompts, bad, want, "bf16")


def test_serve_gang_phase_on_the_cpu(model, card_free):
    cs = _smoke()
    prompts = _prompts()
    outs_bf16 = _ragged(model, prompts, 64, "bf16")
    outs_int8 = _ragged(model, prompts, 64, "int8")
    res = cs.phase_serve_gang(torch, model, prompts, outs_bf16, outs_int8)
    b, i = res["bf16"], res["int8"]
    assert (b["requests"], b["generated_tokens"]) == (16, 16 * 64)
    assert (i["requests"], i["generated_tokens"]) == (4, 4 * 16)
    assert b["paged_attention_per_step"] == 2.0     # one call a layer
    assert b["ragged_per_prefill"] == 2.0
    assert b["prefills"] == 16 and b["preemptions"] == 0
    # 16 rows take every request at once: the prefills sample each first
    # token, then 63 steps of 16 decode rows (the first beside the
    # prefills)
    assert b["steps"] == 63 and b["decode_steps"] == 62
    assert b["decode_calls"]["max_abs_err"] == 0.0
    assert b["decode_calls"]["calls"] == -(-63 // cs.GANG_DECODE_EVERY)
    assert b["decode_calls"]["batch"] == 16
    assert i["decode_calls"]["pool_dtype"] == "int8"
    for m in (b, i):
        assert m["vs_ragged"]["worst_margin"] <= cs.FLIP_MARGIN_MAX
    # every decode step of the shortest and the longest request, against
    # the prefill path over the same context
    lens = [len(p) for p in prompts]
    dl = b["decode_logits"]
    assert dl["requests"] == sorted({lens.index(min(lens)),
                                     lens.index(max(lens))})
    assert dl["steps"] == 2 * 63 and dl["max_abs_err"] <= cs.LOGITS_ATOL
    assert dl["contexts"] == [min(lens) + 1, max(lens) + 63]
    assert 0 <= dl["share_gap_below_drift_p50"] <= 1
    assert "decode_logits" not in i and "step_s" not in b
    # the profiled variant: its last 3 steps in a window of their own
    _, m, _, _ = cs.serve_gang(torch, model, [p[:20] for p in prompts], 8,
                               profile=True)
    assert (m["steps"], m["decode_steps"]) == (7, 3)
    assert "profile_decode" in m


def test_decode_logits_check_refuses_a_wrong_row(model, card_free):
    """A decode step's logits recorded from another row, or a token that
    is not its logits' argmax, is refused."""
    cs = _smoke()
    prompts = _prompts(4, seed=4)
    outs, _, _, taps = cs.serve_gang(torch, model, prompts, 5,
                                     watch=(0, 2))
    assert [(r, j) for r, j, _ in taps] == [
        (r, j) for j in range(1, 5) for r in (0, 2)]
    cs.decode_logits_check(torch, model, prompts, outs, taps, "bf16")
    r, j, row = taps[3]
    other = next(t for t in taps if t[0] != r)[2]
    for bad in ([(r, j, other)], [(r, j - 1, row)]):
        with pytest.raises(AssertionError):
            cs.decode_logits_check(torch, model, prompts, outs, bad, "bf16")


def test_recorder_cost_on_the_cpu(model, card_free, monkeypatch):
    """``recorder_cost``: each run's recorder takes ops on its own parity
    of steps only, the two runs give a cost a step and an op and the
    parity's share, and the flag is back on after it."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import models
    cs = _smoke()

    class Small(ContinuousBatchingEngine):
        def __init__(self, m, **kw):
            kw.pop("kv_pool_bytes")
            super().__init__(m, num_blocks=128, **kw)
    monkeypatch.setattr(models, "ContinuousBatchingEngine", Small)
    out = cs.recorder_cost(torch, model, _prompts(seed=5))
    assert flags.get_flag("flight_recorder") is True
    odd, even = out["gang_decode_step"]["runs"]
    # 16 rows: 63 steps, the first with the prefills; pairs (3, 2) ..
    # (61, 60) with the odd steps on, (4, 3) .. (62, 61) with the even
    assert (odd["on_steps"], odd["pairs"]) == ("odd", 30)
    assert (even["on_steps"], even["pairs"]) == ("even", 30)
    for name in ("gang_decode_step", "eager_ragged_step"):
        got = out[name]
        assert got["ops_per_step"] > 0
        assert got["us_per_op"] == pytest.approx(
            got["host_us_per_step_added"] / got["ops_per_step"])


def test_serving_metrics_check_on_the_cpu(model, card_free, monkeypatch):
    """``serve`` on the CPU (a pool of 64 blocks in place of 8 GiB): its
    series meet its tallies and one span a step; the run with metrics
    and tracing off records nothing; a broken series is refused."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import models
    cs = _smoke()

    class Small(ContinuousBatchingEngine):
        def __init__(self, m, **kw):
            kw.pop("kv_pool_bytes")
            super().__init__(m, num_blocks=128, **kw)
    monkeypatch.setattr(models, "ContinuousBatchingEngine", Small)
    prompts = _prompts(seed=2)
    prompts[-1] = np.concatenate([prompts[0][:8], prompts[-1]])
    outs, m = cs.serve(torch, model, prompts, 6)
    flags.set_flags({"metrics": False, "tracing": False})
    try:
        outs_off, m_off = cs.serve(torch, model, prompts, 6)
    finally:
        flags.set_flags({"metrics": True, "tracing": True})
    m_off["tokens_identical"] = outs_off == outs
    got = cs.check_serving_metrics(torch, m, m_off, [(m, m_off)])
    assert len(got["host_us_per_step_added"]) == 1
    assert got["steps_on_off"] == [(m["steps"], m_off["steps"])]
    assert got["matched"]["serving.admitted"] == 16
    assert got["matched"]["serving.generated_tokens"] == 16 * 6
    assert got["matched"]["serving.prefill_tokens"] == sum(map(len,
                                                               prompts))
    assert got["spans"]["serving_step"] == m["steps"]
    assert got["tokens_identical_off"] is True
    assert got["ttft_s_p50"] is not None
    for broken in ({"metrics": {**m["metrics"], "serving.finished": 15}},
                   {"spans": {**m["spans"], "serving_step": 1}}):
        with pytest.raises(AssertionError):
            cs.check_serving_metrics(torch, {**m, **broken}, m_off)
    with pytest.raises(AssertionError, match="still"):
        cs.check_serving_metrics(torch, m, {**m_off, "spans": m["spans"]})


def test_generate_contiguous_phase_on_the_cpu(model, card_free,
                                              monkeypatch):
    cs = _smoke(on_cpu=True)
    monkeypatch.setattr(cs, "CONTIG_LEN", 48)
    monkeypatch.setattr(cs, "CONTIG_PAD", 16)
    prompts = _prompts(8, lo=48, hi=70, seed=3)
    m = cs.phase_generate_contiguous(torch, model, prompts)
    assert m["contiguous"]["launches"] == {}
    assert m["paged"]["launches"] == {
        "paged_attention": 2 * (cs.GEN_NEW_TOKENS - 1),
        "ragged_paged_attention": 2}
    assert m["vs_paged"]["requests"] == 4
    mp = m["masked_prefill"]
    assert mp["row0"]["max_abs_err"] <= cs.LOGITS_ATOL
    assert mp["row1"]["cosine"] >= cs.LOGITS_MIN_COS
    assert mp["row1_unmasked_max_abs_diff"] > 0.0
    assert m["kvcache_bytes"] == 2 * 2 * 4 * (48 + cs.GEN_NEW_TOKENS) \
        * 2 * 16 * 2
