"""The serving and sampling registry ops against the JAX package's
(``ops.yaml:429-436``, ``:619``), through both packages' ``call_op`` on the
same seeded numpy inputs (``tests/_torch_op_check.py``).

- ``cache_write`` (a scalar tensor position, and a Python int in the
  port), ``paged_cache_write`` and ``paged_cache_write_q``: exactly, the
  int8 codes and their float32 scales at 1e-6;
- ``cache_attention`` with no mask, a bool mask and an additive mask, at
  a decode and a prefill position: atol 1e-5 (float32);
- ``sample_logits`` and ``sample_logits_keyed`` at temperature 0: the
  reference's argmax. At temperature > 0 the bits cannot match threefry:
  the port's draws stay inside the top-k / top-p support, have the
  shape and dtype, come from the port's generator for the logits' device
  (a reseed repeats them) and follow the filtered distribution;
- ``top_p_sampling``: int64 ids ``[B, 1]`` inside each row's nucleus
  (checked against the reference's cut), float32 scores equal to the
  softmax probability of the drawn id at 1e-6.

The last test asserts every op that ``ops/kernels/serving.py`` and
``ops/kernels/extra_misc.py`` register has a case here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from _torch_op_check import check_op
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu.ops.kernels import serving as jsv
from paddle_tpu_torch.ops import dispatcher as tdisp

R = np.random.RandomState


def normal(*shape, seed=0):
    return R(seed).randn(*shape).astype(np.float32)


B, T, KV, H, D = 2, 12, 2, 4, 8
CACHE_MASKS = {
    "none": None,
    "bool": R(5).rand(B, 1, 3, T) > 0.3,
    "additive": np.where(R(6).rand(B, 1, 3, T) > 0.3, 0.0,
                         -1e9).astype(np.float32),
}

CASES = {
    "cache_write": ("cache_write", (normal(B, T, KV, D, seed=1),
                                    normal(B, 3, KV, D, seed=2),
                                    np.asarray(4, np.int32)), {}),
    "paged_cache_write": ("paged_cache_write", (
        normal(6, 4, KV, D, seed=3), normal(2, 3, KV, D, seed=4),
        np.asarray([5, 6, 7, 12, 13, 2], np.int32)), {}),
    "paged_cache_write_q": ("paged_cache_write_q", (
        np.zeros((6, 4, KV, D), np.int8), np.zeros((6, 4, KV), np.float32),
        normal(2, 3, KV, D, seed=7),
        np.asarray([5, 6, 7, 12, 13, 2], np.int32)), {}),
}
for _mname, _mask in CACHE_MASKS.items():
    for _pos, _s in ((8, 1), (0, 3)):
        CASES[f"cache_attention_{_mname}_{_pos}"] = (
            "cache_attention",
            (normal(B, _s, H, D, seed=8), normal(B, T, KV, D, seed=9),
             normal(B, T, KV, D, seed=10), np.asarray(_pos, np.int32)),
            {} if _mask is None else {"attn_mask": _mask[:, :, :_s]})


def _jmask(kw):
    return {k: JTensor(jnp.asarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_op_equals_reference(case):
    name, args, kw = CASES[case]
    if "attn_mask" in kw:
        # a mask is a tensor keyword: both sides get their own tensor
        from _torch_op_check import assert_values, run_port
        want = rdisp.call_op(name, *[JTensor(jnp.asarray(a)) for a in args],
                             **_jmask(kw))
        got, _ = run_port(name, args, {"attn_mask": torch.from_numpy(
            kw["attn_mask"])}, False)
        assert_values(got.numpy(), np.asarray(want.numpy()), 1e-5, 1e-6,
                      case)
        return
    atol = {"cache_attention": 1e-5, "paged_cache_write_q": 1e-6}
    check_op(name, args, kw, atol=atol.get(name, 0), rtol=0, grad=False)


def test_cache_write_takes_a_python_position_in_place():
    cache = torch.from_numpy(normal(B, T, KV, D, seed=1))
    new = torch.from_numpy(normal(B, 3, KV, D, seed=2))
    want = np.asarray(jsv.cache_write_kernel(
        jnp.asarray(cache.numpy()), jnp.asarray(new.numpy()),
        jnp.asarray(4, jnp.int32)))
    out = tdisp.call_op("cache_write", cache, new, 4)
    assert out is cache
    np.testing.assert_array_equal(cache.numpy(), want)


def test_sample_logits_greedy_equals_reference():
    logits = normal(5, 40, seed=11)
    check_op("sample_logits", (logits,), {"temperature": 0.0}, atol=0,
             grad=False)
    keys = R(12).randint(0, 2 ** 31, (5, 2)).astype(np.uint32)
    pos = np.arange(5, dtype=np.int32)
    check_op("sample_logits_keyed",
             (logits, keys.astype(np.int64), pos), {"temperature": 0.0},
             atol=0, grad=False,
             ref=("sample_logits_keyed", (logits, keys, pos),
                  {"temperature": 0.0}))


def _support(logits, top_k, top_p):
    """Each row's allowed ids, from the reference's own filter."""
    filt = np.asarray(jsv._filter_logits(jnp.asarray(logits), 0.7, top_k,
                                         top_p))
    return np.isfinite(filt)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (8, 0.8)])
def test_sample_logits_stays_in_the_filtered_support(top_k, top_p):
    logits = normal(6, 50, seed=13) * 3
    allowed = _support(logits, top_k, top_p)
    P.seed(3)
    t = torch.from_numpy(logits)
    draws = torch.stack([tdisp.call_op("sample_logits", t, temperature=0.7,
                                       top_k=top_k, top_p=top_p)
                         for _ in range(200)])
    assert draws.dtype == torch.int32 and tuple(draws.shape) == (200, 6)
    for r in range(6):
        assert allowed[r][draws[:, r].numpy()].all()
    # the port's generator for the device: a reseed repeats the draws
    P.seed(3)
    again = torch.stack([tdisp.call_op("sample_logits", t, temperature=0.7,
                                       top_k=top_k, top_p=top_p)
                         for _ in range(200)])
    assert torch.equal(draws, again)


def test_sample_logits_follows_the_filtered_distribution():
    logits = np.log(np.asarray([[0.5, 0.3, 0.15, 0.05]], np.float32))
    P.seed(0)
    n = 20000
    draws = tdisp.call_op("sample_logits",
                          torch.from_numpy(np.repeat(logits, n, 0)),
                          temperature=1.0, top_p=0.8)
    freq = np.bincount(draws.numpy(), minlength=4) / n
    # top_p 0.8 keeps {0.5, 0.3} renormalized: 0.625 / 0.375
    np.testing.assert_allclose(freq, [0.625, 0.375, 0, 0], atol=0.02)


def test_sample_logits_keyed_in_support_and_schedule_free():
    logits = torch.from_numpy(normal(4, 30, seed=14) * 2)
    keys = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]])
    pos = torch.tensor([0, 1, 2, 3])
    a = tdisp.call_op("sample_logits_keyed", logits, keys, pos,
                      temperature=0.9, top_k=6)
    allowed = _support(logits.numpy(), 6, 1.0)
    assert a.dtype == torch.int32 and tuple(a.shape) == (4,)
    assert all(allowed[r][int(a[r])] for r in range(4))
    perm = torch.tensor([2, 0, 3, 1])
    b = tdisp.call_op("sample_logits_keyed", logits[perm], keys[perm],
                      pos[perm], temperature=0.9, top_k=6)
    assert torch.equal(b, a[perm])


def test_top_p_sampling_support_scores_and_dtype():
    logits = normal(5, 24, seed=15) * 2
    ps = np.asarray([0.3, 0.6, 0.9, 1.0, 0.05], np.float32)
    # the nucleus each row keeps, from the reference's cut
    s = np.sort(logits, -1)[:, ::-1]
    cum = np.cumsum(np.exp(s - s.max(-1, keepdims=True))
                    / np.exp(s - s.max(-1, keepdims=True)).sum(-1,
                                                               keepdims=True),
                    -1)
    cut = s[np.arange(5), np.minimum((cum < ps[:, None]).sum(-1), 23)]
    allowed = logits >= cut[:, None]
    ref_ids, ref_scores = rdisp.call_op("top_p_sampling",
                                        JTensor(jnp.asarray(logits)),
                                        JTensor(jnp.asarray(ps)))
    ref_ids = np.asarray(ref_ids.numpy())
    assert allowed[np.arange(5), ref_ids[:, 0]].all()
    P.seed(1)
    x = torch.from_numpy(logits)
    probs = torch.softmax(x, -1).numpy()
    for _ in range(50):
        ids, scores = P.top_p_sampling(x, torch.from_numpy(ps))
        ids, scores = ids.numpy(), scores.numpy()
        assert ids.dtype == np.int64 and ids.shape == (5, 1)
        assert scores.dtype == np.float32 and scores.shape == (5, 1)
        assert allowed[np.arange(5), ids[:, 0]].all()
        np.testing.assert_allclose(scores[:, 0],
                                   probs[np.arange(5), ids[:, 0]],
                                   atol=1e-6, rtol=0)
    # p 0.05 keeps only the top id
    assert (ids[4, 0] == logits[4].argmax())


def test_every_serving_op_has_a_case():
    """Every op the port's ``serving.py`` and ``extra_misc.py`` register
    has a case here (``paged_attention`` and ``ragged_paged_attention``
    have theirs in ``test_torch_paged_attention.py`` /
    ``test_torch_ragged_attention.py``; the linalg and fft extras of
    ``extra_misc.py`` theirs in ``test_torch_linalg_fft.py``; its
    single-device op forms theirs in ``test_torch_misc_ops.py``)."""
    from paddle_tpu_torch.ops.kernels import extra_misc, serving
    from test_torch_misc_ops import CASES as OP_FORMS
    owned = {n for n, k in tdisp.KERNELS.items()
             if k.__module__ in (serving.__name__, extra_misc.__name__)} - {
        "matrix_rank", "lu_unpack", "fft_c2c", "fft_r2c", "fft_c2r"} - {
        v[0] for v in OP_FORMS.values()}
    covered = {v[0] for v in CASES.values()} | {
        "sample_logits", "sample_logits_keyed", "top_p_sampling",
        "paged_attention", "ragged_paged_attention"}
    assert len(owned) == 9
    assert owned - covered == set()
    assert owned <= set(tdisp.SCHEMA)
