"""The port's optimizers and fused route against the JAX package's.

The same parameters and grad stream (numpy, seeded, as
``tests/test_fused_optimizer.py`` makes them) go through the port's
``SGD``/``Momentum``/``Adam``/``AdamW`` and through the JAX package's, for
4 steps, in five modes: plain, global-norm clip, GradScaler, a poisoned
grad under the anomaly sentinel, and bf16 params with float32 masters
(plus all of clip + scaler + poison together).

Held within the port: the fused route (on a CPU tensor, the kernel's
plain version) equals the per-param route bit for bit at float32, and the
bf16 write-back bit for bit too.

Held to the reference: float32 params within 8 ulp after 4 steps, the
ulp taken at each tensor's largest magnitude. Both sides round the same
operations in the same order, but XLA on the CPU may contract a multiply
and an add into one FMA inside its fused update programs (measured: the
port equals a numpy evaluation of ``p - lr*g`` where XLA is one ulp off),
and ``pow`` in the bias corrections may differ by an ulp, so bitwise
equality across the packages is not expected. bf16 params with masters
within 1 bf16 ulp (the masters themselves within 8 float32 ulp).
The JAX side runs its fused composite route, and for AdamW also its
Pallas kernel in interpret mode (``fok._FORCE_PALLAS``).

Also held to the reference: ``plan_buckets`` groups, offsets and sizes on
the same specs, and the frozen fallback-reason set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import optimizer as JO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops.kernels.pallas import fused_optimizer as jfok
from paddle_tpu.optimizer.optimizer import \
    FUSED_OPT_FALLBACK_REASONS as J_REASONS
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.amp import GradScaler, update_loss_scaling
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.ops.kernels import fused_optimizer as tfok

OPTS = ("sgd", "momentum", "adam", "adamw")
SHAPES = [(8, 16), (130,), (4, 5), (54,)]
MODES = {
    "plain": {},
    "clip": dict(clip=True),
    "scaler": dict(scaler=True),
    "poison": dict(poison=2),
    "combined": dict(clip=True, scaler=True, poison=2),
    "bf16": dict(bf16=True),
}
F32_ULP = 8


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    tflags.set_flags({"fused_optimizer": True, "anomaly_sentinel": False})
    paddle.set_flags({"FLAGS_fused_optimizer": True,
                      "FLAGS_anomaly_sentinel": False})
    jfok._FORCE_PALLAS = None


def _opt_kw(name):
    return {"sgd": {}, "momentum": dict(momentum=0.9, use_nesterov=True,
                                        weight_decay=0.01),
            "adam": dict(weight_decay=0.01),
            "adamw": dict(weight_decay=0.01)}[name]


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


def _port_run(name, fused=True, *, clip=False, scaler=False, poison=None,
              bf16=False, steps=4):
    tflags.set_flags({"fused_optimizer": fused,
                      "anomaly_sentinel": poison is not None})
    dt = torch.bfloat16 if bf16 else torch.float32
    params = [torch.nn.Parameter(torch.from_numpy(x).to(dt))
              for x in _init()]
    cls = {"sgd": TO.SGD, "momentum": TO.Momentum, "adam": TO.Adam,
           "adamw": TO.AdamW}[name]
    opt = cls(learning_rate=0.01, parameters=params,
              grad_clip=ClipGradByGlobalNorm(1.0) if clip else None,
              **_opt_kw(name))
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


def _jax_run(name, *, clip=False, scaler=False, poison=None, bf16=False,
             steps=4, pallas=False):
    paddle.set_flags({"FLAGS_fused_optimizer": True,
                      "FLAGS_anomaly_sentinel": poison is not None})
    jfok._FORCE_PALLAS = True if pallas else None
    params = [Tensor(x, stop_gradient=False) for x in _init()]
    if bf16:
        params = [Tensor(p._data.astype(jnp.bfloat16), stop_gradient=False)
                  for p in params]
    cls = {"sgd": JO.SGD, "momentum": JO.Momentum, "adam": JO.Adam,
           "adamw": JO.AdamW}[name]
    opt = cls(learning_rate=0.01, parameters=params,
              grad_clip=jnn.ClipGradByGlobalNorm(1.0) if clip else None,
              **_opt_kw(name))
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
    return outs, opt


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.view(torch.int32).numpy()


def _max_ulp(port, ref, dtype):
    """Largest difference in units of the last place of each tensor's
    largest magnitude (an ulp at the element itself would blow up for
    elements near zero, where the two packages' one-ulp differences at
    the tensor's scale show as thousands of the element's ulps)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    worst = 0.0
    for xs, ys in zip(port, ref):
        for x, y in zip(xs, ys):
            a = x.float().numpy().astype(np.float64)
            b = np.asarray(y, np.float64)
            top = np.abs(b).max()
            ulp = 2.0 ** (np.floor(np.log2(top)) - mant) if top > 0 else 1.0
            worst = max(worst, float(np.abs(a - b).max() / ulp))
    return worst


class TestFusedEqualsPerParam:
    @pytest.mark.parametrize("mode", sorted(MODES))
    @pytest.mark.parametrize("name", OPTS)
    def test_bitwise(self, name, mode):
        fused, opt_f = _port_run(name, True, **MODES[mode])
        per, opt_p = _port_run(name, False, **MODES[mode])
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

    def test_routes_are_counted(self):
        TO.fused_counters.update(updates=0, fallbacks=0)
        _port_run("adamw", True, steps=2)
        assert TO.fused_counters["updates"] == 2
        assert TO.fused_counters["buckets"] == 1
        _port_run("adamw", False, steps=2)
        assert TO.fused_counters["fallbacks"] == 2

    def test_bf16_masters_are_flat_views(self):
        _, opt = _port_run("adamw", True, bf16=True, steps=1)
        bases = {m.untyped_storage().data_ptr() for m in opt._masters}
        assert len(bases) == 1, "one flat master buffer per dtype"
        assert all(m.dtype == torch.float32 for m in opt._masters)


class TestAgainstJax:
    @pytest.mark.parametrize("mode", sorted(MODES))
    @pytest.mark.parametrize("name", OPTS)
    def test_tracks_reference(self, name, mode):
        kw = MODES[mode]
        got, opt = _port_run(name, True, **kw)
        want, jopt = _jax_run(name, **kw)
        dt = torch.bfloat16 if kw.get("bf16") else torch.float32
        assert _max_ulp(got, want, dt) <= (1 if kw.get("bf16") else F32_ULP)
        assert opt._step_count == jopt._step_count
        if kw.get("bf16"):   # the float32 masters themselves
            jm = [[np.asarray(m) for m in jopt._masters]]
            assert _max_ulp([opt._masters], jm, torch.float32) <= F32_ULP

    @pytest.mark.parametrize("mode", ["plain", "combined", "bf16"])
    def test_adamw_against_pallas_interpret(self, mode):
        got, _ = _port_run("adamw", True, **MODES[mode])
        want, _ = _jax_run("adamw", pallas=True, **MODES[mode])
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        assert _max_ulp(got, want, dt) <= (1 if mode == "bf16" else F32_ULP)

    def test_poisoned_step_is_skipped_like_reference(self):
        got, opt = _port_run("adam", True, poison=2)
        assert torch.equal(got[1][0], got[2][0])   # step 3 kept everything
        assert opt._step_count == 3
        assert opt.consume_anomaly() == (False, pytest.approx(
            opt._anomaly[1].item()))


def test_plan_buckets_match_reference():
    specs = [((8, 16), "float32", "bfloat16", "bfloat16", 0.01),
             ((130,), "float32", "float32", None, 0.0),
             ((4, 5), "float32", "bfloat16", "bfloat16", 0.01),
             ((), "float32", "float32", None, 0.0),
             ((54,), "bfloat16", "bfloat16", None, 0.01)]
    cfg = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "decoupled": True}
    tp = tfok.plan_buckets("adam", cfg, specs)
    jp = jfok.plan_buckets("adam", cfg, specs)
    assert tp.state_keys == jp.state_keys and tp.n_params == jp.n_params
    assert len(tp.buckets) == len(jp.buckets) == 3
    for a, b in zip(tp.buckets, jp.buckets):
        for f in ("ids", "offsets", "sizes", "shapes", "total", "cdtype",
                  "gdtype", "low", "wd"):
            assert getattr(a, f) == getattr(b, f), f
    assert tfok.STATE_KEYS == jfok.STATE_KEYS


def test_fallback_reasons_are_the_reference_set():
    assert TO.FUSED_OPT_FALLBACK_REASONS == J_REASONS
    assert isinstance(TO.FUSED_OPT_FALLBACK_REASONS, frozenset)
    opt = TO.SGD(parameters=[torch.nn.Parameter(torch.zeros(3))])
    with pytest.raises(ValueError, match="unregistered"):
        opt._fused_fallback("made up")


class TestRouteReasons:
    def _opt(self, cls=TO.AdamW, dtype=torch.float32, **kw):
        p = torch.nn.Parameter(torch.zeros(4, dtype=dtype))
        p.grad = torch.ones(4, dtype=dtype)
        return cls(parameters=[p], **kw), p

    def test_flag_off(self):
        opt, _ = self._opt()
        tflags.set_flags({"fused_optimizer": False})
        opt.step()
        assert opt._fused_last_reason == "FLAGS_fused_optimizer disabled"

    def test_subclass_never_routes_to_stock_kernel(self):
        class MyAdamW(TO.AdamW):
            pass
        opt, _ = self._opt(MyAdamW)
        opt.step()
        assert opt._fused_last_reason == "optimizer rule has no fused kernel"

    def test_hook(self):
        opt, p = self._opt()
        p.register_hook(lambda g: g)
        opt.step()
        assert opt._fused_last_reason == \
            "tensor hook attached to a parameter"

    def test_dtype(self):
        opt, _ = self._opt(dtype=torch.float16, multi_precision=False)
        opt.step()
        assert opt._fused_last_reason == "unsupported param/grad dtype layout"

    def test_value_clip_takes_per_param_without_deferral(self):
        opt, _ = self._opt(grad_clip=ClipGradByValue(0.5))
        assert not opt._fused_defer_scale()
        opt2, _ = self._opt(grad_clip=ClipGradByGlobalNorm(1.0))
        assert opt2._fused_defer_scale()


def test_loss_scaling_transition_matches_reference():
    from paddle_tpu.ops.kernels.extra_misc import update_loss_scaling_kernel
    state = (torch.tensor(8.0), torch.tensor(0, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32))
    jstate = (jnp.float32(8.0), jnp.int32(0), jnp.int32(0))
    for f in [0, 0, 1, 1, 0, 1, 0, 0, 0]:
        state = update_loss_scaling(torch.tensor(bool(f)), *state,
                                    incr_every_n_steps=3,
                                    decr_every_n_nan_or_inf=2)
        jstate = update_loss_scaling_kernel(
            (), jnp.bool_(f), *jstate, incr_every_n_steps=3,
            decr_every_n_nan_or_inf=2)[-3:]
        assert [float(x) for x in state] == [float(x) for x in jstate]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["global_norm", "norm", "value"])
def test_clips_match_reference(kind, dtype):
    # same grads through the port's and the reference's clips: float32
    # within 2 ulp (the norms sum in another order), bf16 within one bf16
    # ulp of each tensor's largest magnitude
    make = {"global_norm": (ClipGradByGlobalNorm, jnn.ClipGradByGlobalNorm,
                            0.5),
            "norm": (ClipGradByNorm, jnn.ClipGradByNorm, 1.5),
            "value": (ClipGradByValue, jnn.ClipGradByValue, 0.7)}[kind]
    gs = _grad_stream(1, None, False)[0]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    port = make[0](make[2])([(None, torch.from_numpy(g).to(tdt))
                             for g in gs])
    ref = make[1](make[2])([(None, Tensor(jnp.asarray(g).astype(dtype)))
                            for g in gs])
    got = [[g for _, g in port]]
    want = [[np.asarray(g._data.astype(jnp.float32)) for _, g in ref]]
    assert all(g.dtype == tdt for g in got[0])
    assert _max_ulp(got, want, tdt) <= (1 if dtype == "bfloat16" else 2)


def test_chunk_table_covers_every_element_once():
    # the kernel's table (built on the host, so testable here): runs of
    # at most CHUNK elements, addresses advancing by the element size,
    # null where a parameter has no write-back or a rule no second slot
    ts = [torch.zeros(tfok.CHUNK * 2 + 5), torch.zeros(3)]
    gs = [torch.zeros(t.shape, dtype=torch.bfloat16) for t in ts]
    lows = [torch.zeros(ts[0].shape, dtype=torch.bfloat16), None]
    states = [{"velocity": torch.zeros(t.shape)} for t in ts]
    rows = tfok.chunk_rows("momentum", ts, gs, states, lows)
    assert rows.shape == (4, 6)
    assert rows[:, 5].tolist() == [tfok.CHUNK, tfok.CHUNK, 5, 3]
    assert rows[1, 0] - rows[0, 0] == 4 * tfok.CHUNK
    assert rows[1, 1] - rows[0, 1] == 2 * tfok.CHUNK
    assert rows[2, 2] - rows[0, 2] == 2 * 2 * tfok.CHUNK
    assert rows[3, 2] == 0 and (rows[:, 4] == 0).all()
    assert rows[3, 3] == states[1]["velocity"].data_ptr()
