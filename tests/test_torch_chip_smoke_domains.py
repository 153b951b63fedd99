"""``chip_smoke.py``'s audio, linalg, graph, Viterbi and registry-tranche
phases, rehearsed on the CPU at a tiny size: the script's ``CARD`` read
as ``"cpu"`` (each card-vs-CPU check then holds the CPU to itself, so
this runs the phases' control flow, invariants and bookkeeping, not the
card's numbers), the sizes shrunk, the CUDA timers replaced by a host
clock. Each phase must pass its own limits, report its timings and
launch none of the fourteen kernels; a planted fault must fail the
graph phase's support check, and a planted kernel launch each phase."""

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cs(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_domains_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)

    def host_time(torch_, fn, iters=10, flush=None):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    def timed_once(torch_, fn):
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    mod.time_ms, mod.timed_once = host_time, timed_once
    mod.CARD = "cpu"
    mod.AUDIO_B, mod.AUDIO_SECONDS, mod.ESC50_SECONDS = 2, 1, 1
    mod.LINALG_MLP, mod.LINALG_SQ, mod.LINALG_RHS = (64, 224), 64, 8
    mod.LINALG_BATCH = (4, 32)
    mod.GRAPH_N, mod.GRAPH_E, mod.GRAPH_D = 2000, 14000, 8
    mod.GRAPH_SEEDS = 256
    mod.VITERBI_B, mod.VITERBI_S, mod.VITERBI_TAGS = 4, 16, 9
    mod.TRANCHE = dict(b=4, w=64, clips=2, frames=9, n_fft=32, img=16,
                       cube=8, sq=16, mat=8, emb=(16, 24, 8), chain=(32, 16))
    from paddle_tpu_torch.core.device import set_device
    yield mod
    set_device(None)


def _no_kernels(res):
    assert res["kernel_launches"] == {}


def test_audio_frontend_phase(cs):
    report = {}
    res = cs.phase_audio_frontend(torch, 0, report)
    assert res["logmel_shape"] == [2, 64, 101]
    assert res["mfcc_shape"] == [2, 40, 101]
    assert res["esc50"]["clips"] == 40 and res["esc50"]["batches"] == 3
    assert res["istft_rel_err"] <= cs.ISTFT_REL
    _no_kernels(res)
    assert report["audio_frontend"] is res


def test_linalg_phase(cs):
    res = cs.phase_linalg(torch, 0, {})
    assert set(res["ms"]) >= {"svd", "qr", "eigh", "eigvalsh", "solve",
                              "cholesky_solve", "lstsq", "det", "slogdet",
                              "pinv", "matrix_rank", "lu", "lu_unpack"}
    assert res["errors"]["matrix_rank_mismatches"] == 0
    _no_kernels(res)


def test_graph_phase(cs):
    res = cs.phase_graph(torch, 0, {})
    assert [h["fanout"] for h in res["sampling"]["hops"]] == [25, 10]
    assert res["sampling"]["hops"][0]["nodes"] == 256
    assert set(res["ops"]) == {"send_u_recv_sum", "send_u_recv_mean",
                               "send_u_recv_max", "send_ue_recv_mul",
                               "send_uv_add"}
    _no_kernels(res)


def test_graph_phase_refuses_a_wrong_sampler(cs, monkeypatch):
    from paddle_tpu_torch import geometric
    real = geometric.sample_neighbors

    def shifted(*a, **k):
        out, cnt, e = real(*a, **k)
        return (out + 1) % cs.GRAPH_N, cnt, e
    monkeypatch.setattr(geometric, "sample_neighbors", shifted)
    with pytest.raises(AssertionError, match="graph: beyond the limits"):
        cs.phase_graph(torch, 0, {})


def test_text_viterbi_phase(cs):
    res = cs.phase_text_viterbi(torch, 0, {})
    for key in ("bos_eos", "plain"):
        assert res[key]["captured_equal"]
        assert res[key]["path_mismatches_decided"] == 0
        assert res[key]["decided_rows"] >= 1
    _no_kernels(res)


def test_viterbi_margins_find_the_close_calls(cs):
    pot = np.zeros((1, 3, 4))
    trans = np.zeros((4, 4))
    _, margin = cs.viterbi_margins(pot, trans, np.array([3]), False)
    assert margin[0] == 0.0             # every path ties
    pot[0, :, 1] = 1.0
    _, margin = cs.viterbi_margins(pot, trans, np.array([3]), False)
    assert margin[0] == pytest.approx(1.0)


def test_registry_tranche_phase(cs):
    report = {}
    res = cs.phase_registry_tranche(torch, 0, report)
    assert len(res) == 76
    assert res["fft"]["backward"] and not res["eig"]["backward"]
    assert report["registry_tranche"]["kernel_launches"] == {}


@pytest.mark.parametrize("phase", ["audio_frontend", "linalg", "graph",
                                   "text_viterbi", "registry_tranche"])
def test_phase_refuses_a_kernel_launch(cs, monkeypatch, phase):
    from paddle_tpu_torch.ops import kernels
    calls = []

    def counts():                     # one flash launch between each read
        calls.append(1)
        return {"flash_fwd": len(calls)}
    monkeypatch.setattr(kernels, "launch_counts", counts)
    cases = cs.registry_tranche_cases
    monkeypatch.setattr(cs, "registry_tranche_cases",
                        lambda rng: list(cases(rng))[-3:])
    with pytest.raises(AssertionError, match="kernel_launches"):
        getattr(cs, f"phase_{phase}")(torch, 0, {})
