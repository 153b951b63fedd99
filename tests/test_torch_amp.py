"""The port's AMP (``paddle_tpu_torch.amp``) against the JAX package's.

- ``WHITE_LIST``/``BLACK_LIST`` equal the reference's sets, and
  ``cast_spec`` gives the reference's decision (low dtype, cast to low,
  black) for every listed op and a few unlisted ones, off, at O1 and at O2,
  with and without custom lists; ``apply_cast_spec`` casts a float32, a
  bf16 and an int tensor to the reference's dtypes.
- The Llama-tiny model (float32) under ``auto_cast(level="O1")``, and
  decorated to bf16 with ``decorate`` and run under O2, against the
  reference on the same weights and ids (seq 128, the reference's flash
  kernel in interpret mode): the logits and the loss have the reference's
  dtypes; the logits within atol 5e-2 and the loss within atol 2e-3 (the
  bf16 limits of ``tests/test_torch_llama_training.py``); every grad
  within 5e-2 of the tensor's largest magnitude (measured 1.8e-2 at O1,
  1.6e-2 at O2: bf16 products round in another order) and cosine >=
  0.999. The grads are compared as float32: the port's are in each
  parameter's dtype (torch's autograd casts back through the AMP cast, as
  the reference's ``TrainStep`` grads are), where the reference's eager
  tape leaves a cast op's grad in the cast dtype.
- The dtype of every output of every hooked op (by the reference's op
  names, in call order) equals the reference's at O1 and at O2: the
  port's raw tensor arithmetic, which the choke point does not hook,
  changes no dtype on the Llama path.
- ``decorate`` keeps the ``Parameter`` objects (an optimizer built before
  it trains the bf16 parameters with float32 masters) and casts the
  floating buffers too, as the reference's ``Layer.to`` does.
- ``GradScaler``'s ``minimize``, ``update``, ``is_enable``,
  ``get_loss_scaling``, ``state_dict`` and ``set_state_dict`` give the
  reference's values over a run with a non-finite step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import accuracy_compare as jac
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JModel
from paddle_tpu.models import LlamaPretrainingCriterion as JCrit
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as TO
from paddle_tpu_torch.amp import accuracy_compare as tac
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     from_jax_state_dict, named_grads)
from paddle_tpu_torch.ops import dispatcher

SEQ = 128
OPS = sorted(tamp.WHITE_LIST | tamp.BLACK_LIST) + [
    "add", "rope", "swiglu", "embedding", "fused_softmax_ce", "reshape"]


@pytest.fixture(autouse=True)
def _no_tp():
    from paddle_tpu.distributed import topology
    saved = topology.get_hybrid_communicate_group()
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(saved)


def test_lists_equal_reference():
    assert tamp.WHITE_LIST == paddle.amp.WHITE_LIST
    assert tamp.BLACK_LIST == paddle.amp.BLACK_LIST


def _spec(mod, name):
    s = mod.cast_spec(name)
    if s is None:
        return None
    low = str(s[0]).removeprefix("torch.") \
        if isinstance(s[0], torch.dtype) else jnp.dtype(s[0]).name
    return (low, s[1], s[2])


@pytest.mark.parametrize("custom", [False, True], ids=["lists", "custom"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_cast_spec_matches_reference(level, custom):
    kw = dict(custom_white_list={"rms_norm", "add", "exp"},
              custom_black_list={"matmul", "swiglu"}) if custom else {}
    assert all(_spec(m, "linear") is None for m in (tamp, paddle.amp))
    with paddle.amp.auto_cast(level=level, **kw), \
            tamp.auto_cast(level=level, **kw):
        for name in OPS:
            assert _spec(tamp, name) == _spec(paddle.amp, name), name
    assert dispatcher._AMP_HOOK is None        # restored on exit
    assert _spec(tamp, "linear") is None


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", ["linear", "rms_norm", "rope", "mean"])
def test_apply_cast_spec_matches_reference(level, name):
    xs = [np.ones((2, 3), np.float32), np.ones((2, 3), np.float32),
          np.arange(6, dtype=np.int32)]
    with paddle.amp.auto_cast(level=level), tamp.auto_cast(level=level):
        want = paddle.amp.apply_cast_spec(
            [jnp.asarray(xs[0]), jnp.asarray(xs[1]).astype(jnp.bfloat16),
             jnp.asarray(xs[2])], paddle.amp.cast_spec(name))
        got = tamp.apply_cast_spec(
            [torch.from_numpy(xs[0]), torch.from_numpy(xs[1]).bfloat16(),
             torch.from_numpy(xs[2]), "not a tensor"],
            tamp.cast_spec(name))
    assert [str(t.dtype).removeprefix("torch.") for t in got[:3]] == \
        [str(a.dtype) for a in want]
    assert got[3] == "not a tensor"


def _pair():
    paddle.seed(0)
    jm = JModel(JConfig(**dataclasses.asdict(JConfig.tiny())))
    jm.train()
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    from_jax_state_dict(tm, {k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _ids():
    return np.random.RandomState(0).randint(0, 256, (2, SEQ)) \
        .astype(np.int32)


@pytest.fixture(scope="module", params=["O1", "O2"])
def amp_run(request, tmp_path_factory):
    """Logits, loss, grads and the hooked ops' output dtypes of one batch
    under ``level`` through both packages."""
    level = request.param
    tmp = tmp_path_factory.mktemp(f"amp_{level}")
    jm, tm = _pair()
    if level == "O2":
        paddle.amp.decorate(jm, level="O2")
        tamp.decorate(tm, level="O2")
    ids = _ids()
    with paddle.amp.auto_cast(level=level), \
            jac.collect_tensor_infos(str(tmp / "j")) as jinfos:
        jl = jm(Tensor(ids))
        jloss = JCrit()(jl, Tensor(ids))
    jloss.backward()
    t_ids = torch.from_numpy(ids)
    with tamp.auto_cast(level=level), \
            tac.collect_tensor_infos(str(tmp / "t")) as tinfos:
        tl = tm(t_ids)
        tloss = LlamaPretrainingCriterion()(tl, t_ids)
    tloss.backward()
    jg = {n: np.asarray(p.grad._data.astype(jnp.float32))
          for n, p in jm.named_parameters()}
    return dict(level=level, jl=jl._data, jloss=jloss._data, tl=tl.detach(),
                tloss=tloss.detach(), jg=jg, tg=named_grads(tm), tm=tm,
                jinfos=jinfos, tinfos=tinfos)


def test_logits_and_loss_dtypes_and_values(amp_run):
    r = amp_run
    assert str(r["tl"].dtype) == "torch." + str(r["jl"].dtype)
    assert str(r["tloss"].dtype) == "torch." + str(r["jloss"].dtype)
    np.testing.assert_allclose(r["tl"].float().numpy(),
                               np.asarray(r["jl"].astype(jnp.float32)),
                               atol=5e-2, rtol=0)
    assert abs(float(r["tloss"]) - float(r["jloss"])) < 2e-3


def test_grads_match(amp_run):
    r = amp_run
    assert set(r["tg"]) == set(r["jg"])
    want_dtype = torch.bfloat16 if r["level"] == "O2" else torch.float32
    assert all(p.grad.dtype == want_dtype for p in r["tm"].parameters())
    for n, want in r["jg"].items():
        got = r["tg"][n]
        rel = np.abs(got - want).max() / np.abs(want).max()
        cos = float((got * want).sum() / np.sqrt((got * got).sum()
                                                 * (want * want).sum()))
        assert rel < 5e-2 and cos >= 0.999, (n, rel, cos)


def test_hooked_op_output_dtypes_equal_reference(amp_run):
    r = amp_run
    names = {i.op_type for i in r["tinfos"]}
    assert names == {"embedding", "rms_norm", "linear", "rope",
                     "flash_attention", "swiglu", "fused_softmax_ce", "mean"}
    want = [(i.tensor_name, i.dtype) for i in r["jinfos"]
            if i.op_type in names]
    got = [(i.tensor_name, i.dtype) for i in r["tinfos"]]
    assert got == want


def test_decorate_keeps_parameters_and_casts_buffers():
    _, tm = _pair()
    params = list(tm.parameters())
    opt = TO.AdamW(learning_rate=1e-3, parameters=params)
    out = tamp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert out == (tm, opt)
    assert all(a is b for a, b in zip(params, tm.parameters()))
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    assert all(b.dtype == torch.bfloat16 for b in tm.buffers())
    assert tamp.decorate([tm]) == [tm]
    ids = torch.from_numpy(_ids()[:, :32])
    with tamp.auto_cast(level="O2"):
        LlamaPretrainingCriterion()(tm(ids), ids).backward()
    before = [p.detach().float() for p in params]
    opt.step()
    assert all(m is not None and m.dtype == torch.float32
               for m in opt._masters)
    assert all(not torch.equal(a, m) for a, m in zip(before, opt._masters))


def _scaler_run(mod, t):
    """A GradScaler over one SGD parameter: finite, non-finite, finite,
    finite steps through ``minimize``; the scaler's view after each."""
    sc = mod.GradScaler(init_loss_scaling=16.0, incr_every_n_steps=2,
                        decr_every_n_nan_or_inf=1)
    out = [(sc.is_enable(), sc.get_loss_scaling(), sc.state_dict())]
    if t is torch:
        w = torch.nn.Parameter(torch.ones(3))
        opt = TO.SGD(learning_rate=0.1, parameters=[w])
    else:
        w = Tensor(np.ones(3, np.float32), stop_gradient=False)
        opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[w])
    for k in (2.0, float("inf"), 3.0, 0.5):
        x = np.full(3, k, np.float32)
        loss = (w * (torch.from_numpy(x) if t is torch
                     else Tensor(x))).sum()
        scaled = sc.scale(loss)
        scaled.backward()
        sc.minimize(opt, scaled)
        sc.update()
        out.append((sc.is_enable(), sc.get_loss_scaling(), sc.state_dict()))
    w_np = w.detach().numpy() if t is torch else np.asarray(w._data)
    return out, w_np, sc


def test_grad_scaler_methods_match_reference():
    got, tw, tsc = _scaler_run(tamp, torch)
    want, jw, jsc = _scaler_run(paddle.amp, None)
    assert got == want
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=0)
    for sd in ({"scale": 4.0, "good": 1, "bad": 0}, want[2][2]):
        fresh, live = tamp.GradScaler(), tsc     # lazy and made state
        for sc in (fresh, live):
            sc.set_state_dict(sd)
            assert sc.state_dict() == sd
            assert sc.get_loss_scaling() == sd["scale"]
    off = tamp.GradScaler(enable=False)
    assert not off.is_enable() and off.get_loss_scaling() == 1.0
    assert off.state_dict() == paddle.amp.GradScaler(
        enable=False).state_dict()
