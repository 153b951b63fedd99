"""The port's Lamb optimizer against the JAX package's ``Lamb``.

The same parameters and grad stream (numpy, seeded, as
``tests/test_fused_optimizer.py`` makes them) go through the port's
``optimizer.Lamb`` and the JAX package's for 4 steps, in the modes of
``test_torch_fused_optimizer.py``: plain, global-norm clip, GradScaler, a
poisoned grad under the anomaly sentinel, all three together, and bf16
params with float32 masters.

Held to the reference:

- float32 params (and the float32 masters of bf16 params) at the
  reference's own numpy tolerance (``tests/test_nn.py``: rtol 2e-5, atol
  2e-6); bf16 params within one bf16 ulp of each tensor's largest
  magnitude, with the count of elements that differ at all reported in
  the assertion (measured: 0 of the 4 x 332 bf16 values differ);
- the reference's numpy Lamb and its ``exclude_from_weight_decay_fn``
  case, which gets the parameter, not its name;
- a tiny float32 Llama (``LlamaConfig.tiny()``, weights moved across)
  trained 4 steps through ``TrainStep`` with Lamb, clip and an excluded
  set of 1-D parameters: every loss within 1e-5, and every parameter at
  rtol 2e-5, atol 2e-6 but for at most 1 in 10^4 elements (the grads
  differ by ~1e-5 relative across the packages, and Lamb, like Adam,
  moves an element by about lr·r whatever its grad's size, so an element
  whose grad is near 0 can take another direction; measured: losses
  4.8e-7 apart, 0 of 106816 elements outside, the largest gap 3.9e-7);
- the plain Lamb bucket (two passes around the trust ratios) against the
  JAX package's Pallas Lamb bucket in interpret mode
  (``_FORCE_PALLAS``), within 8 float32 ulp of each tensor's largest
  magnitude (the reference contracts multiply-adds into FMAs).

Held within the port: the fused route (on a CPU tensor, the kernel's
plain version) equals the per-param route bit for bit at float32 in every
mode, masters, moments and bf16 params; an excluded parameter forms a
bucket of its own.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu.ops.kernels.pallas import fused_optimizer as jfok
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.kernels import fused_optimizer as tfok

SHAPES = [(8, 16), (130,), (4, 5), (54,)]
MODES = {
    "plain": {},
    "clip": dict(clip=True),
    "scaler": dict(scaler=True),
    "poison": dict(poison=2),
    "combined": dict(clip=True, scaler=True, poison=2),
    "bf16": dict(bf16=True),
}
RTOL, ATOL = 2e-5, 2e-6       # tests/test_nn.py's Lamb tolerance
LAMB_KW = dict(learning_rate=0.01, lamb_weight_decay=0.01)


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    tflags.set_flags({"fused_optimizer": True, "anomaly_sentinel": False})
    paddle.set_flags({"FLAGS_fused_optimizer": True,
                      "FLAGS_anomaly_sentinel": False})
    jfok._FORCE_PALLAS = None


def _grad_stream(steps, poison, scaler):
    rng = np.random.RandomState(123)
    out = []
    for t in range(steps):
        gs = []
        for k, s in enumerate(SHAPES):
            g = rng.randn(*s).astype(np.float32)
            if poison is not None and t == poison and k == 1:
                g[3] = np.nan
            gs.append(g * 16.0 if scaler else g)
        out.append(gs)
    return out


def _init():
    rng = np.random.RandomState(0)
    return [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]


def _port_run(fused=True, *, clip=False, scaler=False, poison=None,
              bf16=False, steps=4, exclude=None):
    tflags.set_flags({"fused_optimizer": fused,
                      "anomaly_sentinel": poison is not None})
    dt = torch.bfloat16 if bf16 else torch.float32
    params = [torch.nn.Parameter(torch.from_numpy(x).to(dt))
              for x in _init()]
    opt = TO.Lamb(parameters=params,
                  grad_clip=ClipGradByGlobalNorm(1.0) if clip else None,
                  exclude_from_weight_decay_fn=exclude, **LAMB_KW)
    sc = GradScaler(init_loss_scaling=16.0) if scaler else None
    outs = []
    for gs in _grad_stream(steps, poison, scaler):
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g).to(dt)
        if sc is not None:
            sc.step(opt)
        else:
            opt.step()
        opt.clear_grad()
        outs.append([p.detach().clone() for p in params])
    return outs, opt


def _jax_run(*, clip=False, scaler=False, poison=None, bf16=False,
             steps=4):
    paddle.set_flags({"FLAGS_fused_optimizer": True,
                      "FLAGS_anomaly_sentinel": poison is not None})
    params = [Tensor(x, stop_gradient=False) for x in _init()]
    if bf16:
        params = [Tensor(p._data.astype(jnp.bfloat16), stop_gradient=False)
                  for p in params]
    opt = JO.Lamb(parameters=params,
                  grad_clip=jnn.ClipGradByGlobalNorm(1.0) if clip else None,
                  **LAMB_KW)
    sc = paddle.amp.GradScaler(init_loss_scaling=16.0) if scaler else None
    outs = []
    for gs in _grad_stream(steps, poison, scaler):
        for p, g in zip(params, gs):
            gd = jnp.asarray(g)
            p.grad = Tensor(gd.astype(jnp.bfloat16) if bf16 else gd)
        if sc is not None:
            sc.step(opt)
            sc.update()
        else:
            opt.step()
        opt.clear_grad()
        outs.append([np.asarray(p._data.astype(jnp.float32)).copy()
                     for p in params])
    masters = [None if m is None else np.asarray(m, np.float32)
               for m in opt._masters]
    return outs, masters


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.view(torch.int32).numpy()


def _ulps(a, b, mant):
    """Largest difference in ulps of b's largest magnitude, and the count
    of elements that differ at all."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    top = np.abs(b).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - mant) if top > 0 else 1.0
    return float(np.abs(a - b).max() / ulp), int((a != b).sum())


class TestAgainstReference:
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_four_steps_track_reference(self, mode):
        got, opt = _port_run(**MODES[mode])
        want, jmasters = _jax_run(**MODES[mode])
        if mode != "bf16":
            for t, (xs, ys) in enumerate(zip(got, want)):
                for k, (x, y) in enumerate(zip(xs, ys)):
                    np.testing.assert_allclose(x.numpy(), y, rtol=RTOL,
                                               atol=ATOL, err_msg=f"{t} {k}")
            return
        for t, (xs, ys) in enumerate(zip(got, want)):
            for k, (x, y) in enumerate(zip(xs, ys)):
                ulps, n = _ulps(x.float().numpy(), y, 7)
                assert ulps <= 1, (t, k, ulps, f"{n} of {y.size} differ")
        for m, jm in zip(opt._masters, jmasters):
            np.testing.assert_allclose(m.numpy(), jm, rtol=RTOL, atol=ATOL)

    def test_reference_numpy_case(self):
        # tests/test_nn.py's case: Lamb against float64 numpy, 4 steps
        r = np.random.RandomState(0)
        grads = [r.randn(5).astype(np.float32) for _ in range(4)]
        w0 = np.random.RandomState(1).randn(5).astype(np.float32)
        w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = TO.Lamb(learning_rate=0.01, lamb_weight_decay=0.1,
                      parameters=[w])
        p = w0.astype(np.float64).copy()
        m = v = np.zeros_like(p)
        b1, b2, eps, wd, lr = 0.9, 0.999, 1e-6, 0.1, 0.01
        for t, g in enumerate(grads, 1):
            (w * torch.from_numpy(g)).sum().backward()
            opt.step()
            opt.clear_grad()
            g = g.astype(np.float64)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            tr = m / (1 - b1 ** t) / (np.sqrt(v / (1 - b2 ** t)) + eps) \
                + wd * p
            pn, tn = np.linalg.norm(p), np.linalg.norm(tr)
            p = p - lr * (pn / tn if (pn > 0 and tn > 0) else 1.0) * tr
            np.testing.assert_allclose(w.detach().numpy(), p, rtol=RTOL,
                                       atol=ATOL)

    def test_exclude_fn_gets_the_parameter(self):
        # the reference's case: zero grad, decay excluded -> tr_div 0 -> no
        # movement; the function sees the parameter object itself
        w = torch.nn.Parameter(torch.full((3,), 5.0))
        seen = []

        def exclude(p):
            seen.append(p)
            return p is w
        opt = TO.Lamb(learning_rate=0.1, lamb_weight_decay=0.5,
                      parameters=[w], exclude_from_weight_decay_fn=exclude)
        (w * 0.0).sum().backward()
        opt.step()
        assert seen and all(p is w for p in seen)
        np.testing.assert_allclose(w.detach().numpy(), 5.0, rtol=1e-6)


class TestFusedEqualsPerParam:
    @pytest.mark.parametrize("mode", sorted(MODES))
    def test_bitwise(self, mode):
        fused, opt_f = _port_run(True, **MODES[mode])
        per, opt_p = _port_run(False, **MODES[mode])
        assert opt_f._fused_last_reason is None
        assert opt_p._fused_last_reason == "FLAGS_fused_optimizer disabled"
        for t, (xs, ys) in enumerate(zip(fused, per)):
            for k, (x, y) in enumerate(zip(xs, ys)):
                assert np.array_equal(_bits(x), _bits(y)), (t, k)
        for sa, sb in zip(opt_f._states, opt_p._states):
            for key in sa:
                assert torch.equal(sa[key], sb[key]), key
        for ma, mb in zip(opt_f._masters, opt_p._masters):
            assert (ma is None) == (mb is None)
            if ma is not None:
                assert torch.equal(ma, mb)
        assert opt_f._step_count == opt_p._step_count

    def test_excluded_parameters_form_their_own_bucket(self):
        one_d = lambda p: p.dim() == 1  # noqa: E731
        fused, opt = _port_run(True, exclude=one_d)
        per, _ = _port_run(False, exclude=one_d)
        plan = next(iter(opt._fused_plans.values()))
        assert [b.wd for b in plan.buckets] == [0.01, 0.0]
        assert [b.ids for b in plan.buckets] == [(0, 2), (1, 3)]
        for xs, ys in zip(fused, per):
            for x, y in zip(xs, ys):
                assert torch.equal(x, y)


def test_plain_bucket_matches_reference_pallas_bucket():
    """The port's plain Lamb bucket against the JAX package's Pallas Lamb
    bucket (interpret mode) on one bucket of float32 masters with a bf16
    write-back, unscale and clip folded. The grads are float32: over bf16
    grads the interpret route keeps ``g·inv·coeff`` in float32 between
    the two multiplies (XLA's excess precision), one bf16 ulp away from
    its own composite route, which the port equals bit for bit."""
    cfg = {"b1": 0.9, "b2": 0.999, "eps": 1e-6}
    rng = np.random.RandomState(7)
    ps = [(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]
    gs = [(rng.randn(*s) * 8).astype(np.float32) for s in SHAPES]
    ms = [(rng.rand(*s) * 0.01).astype(np.float32) for s in SHAPES]
    vs = [(rng.rand(*s) * 0.001).astype(np.float32) for s in SHAPES]
    lr, step, inv, coeff, wd = 0.01, 3, 1 / 8, 0.75, 0.01
    specs = [(s, "float32", "float32", "bfloat16", wd) for s in SHAPES]
    jplan = jfok.plan_buckets("lamb", cfg, specs)
    jfok._FORCE_PALLAS = True
    jp, js, jlow = jfok.fused_apply(
        jplan, [jnp.asarray(p) for p in ps], [jnp.asarray(g) for g in gs],
        [{"m": jnp.asarray(m), "v": jnp.asarray(v)} for m, v in zip(ms, vs)],
        lr, step, inv, coeff, 0.0, use_pallas=True)
    one = torch.ones(())
    bc1, bc2 = tfok.bias_inv(cfg["b1"], cfg["b2"], one * step)
    svec = tfok.pack_scalars(lr=one * lr, step=one * step, inv=one * inv,
                             coeff=one * coeff, found=one * 0, wd=one * wd,
                             inv_bc1=bc1, inv_bc2=bc2)
    tp = [torch.from_numpy(p.copy()) for p in ps]
    tst = [{"m": torch.from_numpy(m.copy()), "v": torch.from_numpy(v.copy())}
           for m, v in zip(ms, vs)]
    tlow = [torch.zeros(s, dtype=torch.bfloat16) for s in SHAPES]
    tfok.fused_bucket("lamb", cfg, tp, [torch.from_numpy(g) for g in gs],
                      tst, tlow, svec)
    for k in range(len(SHAPES)):
        for got, want in ((tp[k], jp[k]), (tst[k]["m"], js[k]["m"]),
                          (tst[k]["v"], js[k]["v"])):
            ulps, _ = _ulps(got.numpy(), np.asarray(want), 23)
            assert ulps <= 8, (k, ulps)
        ulps, _ = _ulps(tlow[k].float().numpy(),
                        np.asarray(jlow[k].astype(jnp.float32)), 7)
        assert ulps <= 1, (k, ulps)


def test_trust_ratio_batched_equals_single():
    """The bucket's stacked ratios equal each parameter's own, bit for
    bit, including a zero parameter (ratio 1) and a zero tr_div."""
    g = torch.Generator().manual_seed(3)
    ps = [torch.randn(s, generator=g) for s in SHAPES] + [torch.zeros(7)]
    trs = [torch.randn(p.shape, generator=g) for p in ps]
    trs[2].zero_()
    out = torch.empty(len(ps))
    tfok.lamb_trust_ratios(ps, trs, out=out)
    single = torch.stack([tfok.lamb_trust_ratio(p, t)
                          for p, t in zip(ps, trs)])
    assert torch.equal(out, single)
    assert out[2] == 1 and out[-1] == 1


def test_lamb_scratch_segments_are_aligned():
    ps = [torch.zeros(s) for s in SHAPES]
    trs, ratios = tfok.lamb_scratch(ps)
    assert [t.shape for t in trs] == [p.shape for p in ps]
    assert all((t.data_ptr() - trs[0].data_ptr()) % tfok.SCRATCH_ALIGN == 0
               for t in trs)
    assert ratios.dtype == torch.float32 and ratios.shape == (len(ps),)
    rows = tfok.chunk_rows("lamb", ps, [p.bfloat16() for p in ps],
                           [{"m": p, "v": p} for p in ps], [None] * len(ps),
                           (trs, ratios))
    assert rows[:, 5].tolist() == [t.data_ptr() for t in trs]
    assert rows[:, 6].tolist() == [ratios.data_ptr() + 4 * k
                                   for k in range(len(ps))]


# -- a tiny Llama through TrainStep --------------------------------------------

def _one_d(p):
    return p.ndim == 1


def test_tiny_llama_four_lamb_steps_track_reference():
    paddle.seed(0)
    jm = JModel(JConfig.tiny())
    jm.train()
    tm = LlamaForCausalLM(dataclasses.replace(LlamaConfig.tiny()),
                          device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(5).randint(0, 256, (2, 128)).astype(np.int32)
    jopt = JO.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
                   parameters=jm.parameters(),
                   grad_clip=jnn.ClipGradByGlobalNorm(1.0),
                   exclude_from_weight_decay_fn=lambda p: p.ndim == 1)
    jcrit, jlosses = JCrit(), []
    for _ in range(4):
        loss = jcrit(jm(Tensor(ids)), Tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jlosses.append(float(loss._data))
    topt = TO.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
                   parameters=tm.parameters(),
                   grad_clip=ClipGradByGlobalNorm(1.0),
                   exclude_from_weight_decay_fn=_one_d)
    train = TrainStep(tm, LlamaPretrainingCriterion(), topt)
    t_ids = torch.from_numpy(ids)
    tlosses = [float(train((t_ids,), (t_ids,))) for _ in range(4)]
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=0)
    plan = next(iter(topt._fused_plans.values()))
    assert sorted(b.wd for b in plan.buckets) == [0.0, 0.01]
    jp = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    bad = total = 0
    for n, p in tm.named_parameters():
        a, b = p.detach().numpy(), jp[n]
        bad += int((np.abs(a - b) > ATOL + RTOL * np.abs(b)).sum())
        total += b.size
    assert bad <= total // 10 ** 4, f"{bad} of {total} elements differ"


def test_kernel_route_glue_with_passes_emulated(monkeypatch):
    """The kernel route's glue on the CPU: the scratch, the chunk table,
    the trust ratios between the passes and the launch counts, with each
    CUDA pass stood in for by its plain version writing where the kernel
    writes (tr_div into the scratch, the ratios read from its buffer). It
    equals the plain bucket bit for bit over a step and a found = 1
    step."""
    cfg = {"b1": 0.9, "b2": 0.999, "eps": 1e-6}
    launched = []

    def emulated(name, kind, cfg_, targets, grads, states, lows, svec,
                 bucket=None, scratch=None):
        rows = tfok.chunk_rows(kind, targets, grads, states, lows, scratch)
        assert (rows[:, 5] != 0).all() and (rows[:, 6] != 0).all()
        if name == "lamb_moments":
            for t, v in zip(scratch[0], tfok.lamb_moments_plain(
                    cfg_, targets, grads, states, svec)):
                t.copy_(v)
        else:
            tfok.lamb_apply_plain(targets, scratch[0], scratch[1], lows,
                                  svec)
        launched.append(name)
    monkeypatch.setattr(tfok, "launch_pass", emulated)
    rng = np.random.RandomState(9)

    def bucket_tensors():
        ps = [torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
              for s in SHAPES]
        return (ps, [torch.from_numpy(rng.randn(*s).astype(np.float32))
                     .bfloat16() for s in SHAPES],
                [{"m": torch.zeros(s), "v": torch.zeros(s)} for s in SHAPES],
                [p.bfloat16() for p in ps])
    a = bucket_tensors()
    b = ([t.clone() for t in a[0]], a[1],
         [{k: t.clone() for k, t in s.items()} for s in a[2]],
         [t.clone() for t in a[3]])
    bucket = tfok.plan_buckets("lamb", cfg, [
        (s, "float32", "bfloat16", "bfloat16", 0.01)
        for s in SHAPES]).buckets[0]
    one = torch.ones(())
    for step, found in ((1, 0.0), (2, 1.0)):
        bc1, bc2 = tfok.bias_inv(0.9, 0.999, one * step)
        svec = tfok.pack_scalars(lr=one * 1e-2, step=one * step, inv=one / 4,
                                 coeff=one * 0.5, found=one * found,
                                 wd=one * 0.01, inv_bc1=bc1, inv_bc2=bc2)
        tfok.fused_bucket_kernel("lamb", cfg, *a, svec, bucket)
        tfok.fused_bucket_plain("lamb", cfg, *b, svec)
        for x, y in zip(a[0] + a[3], b[0] + b[3]):
            assert torch.equal(x, y)
        for sx, sy in zip(a[2], b[2]):
            assert torch.equal(sx["m"], sy["m"])
            assert torch.equal(sx["v"], sy["v"])
    assert launched == ["lamb_moments", "lamb_apply"] * 2
    assert bucket.scratch is not None
