"""The port's transformer blocks (``nn/transformer.py``) against the JAX
package's, on the CPU, and the two repairs that attention dropout needed.

Held to the reference with converted weights and dropout 0 (float32, atol
1e-5): ``MultiHeadAttention`` with a bool and a float mask, a pre-norm and
a post-norm ``TransformerEncoderLayer``, and a 2-layer
``TransformerEncoder``: outputs, input grads and every parameter grad.

Attention dropout (``scaled_dot_product_attention`` through ``call_op``):
at p 0.5 it changes the output, keeps about half the probabilities and
scales the kept ones by 2; at p 0 it is the identity (bit for bit the
call without dropout); it draws from the port's generator, never torch's
global one. ``TransformerEncoder``'s deep copies draw masks of their own:
layers 0 and 1 see different masks.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.models import from_jax_state_dict
from paddle_tpu_torch.nn.initializer import seed as port_seed
from paddle_tpu_torch.ops.dispatcher import call_op

TOL = dict(atol=1e-5, rtol=1e-5)
D, NH, FF, S, B = 16, 4, 32, 6, 2


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _n(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(build):
    paddle.seed(0)
    jl = build(jnn)
    tl = build(tnn)
    from_jax_state_dict(tl, {k: np.asarray(v._data)
                             for k, v in jl.state_dict().items()})
    return jl, tl


def _check(jl, tl, x, mask=None):
    jx = Tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    jm = None if mask is None else Tensor(mask)
    tm = None if mask is None else torch.from_numpy(mask.copy())
    if isinstance(jl, jnn.MultiHeadAttention):
        jout, tout = jl(jx, attn_mask=jm), tl(tx, attn_mask=tm)
    else:
        jout, tout = jl(jx, jm), tl(tx, tm)
    ct = _n(*jout.shape, seed=9)
    (jout * Tensor(ct)).sum().backward()
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **TOL)
    jg = {n: p.grad.numpy() for n, p in jl.named_parameters()}
    tg = {n: p.grad.numpy() for n, p in tl.named_parameters()}
    assert set(jg) == set(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **TOL)


def _masks():
    keep = np.ones((B, 1, S, S), bool)
    keep[1, :, :, -2:] = False
    add = np.where(keep, 0.0, -1e9).astype(np.float32)
    return {"none": None, "bool": keep, "float": add}


@pytest.mark.parametrize("mask", ["none", "bool", "float"])
def test_multi_head_attention_matches_reference(mask):
    jl, tl = _pair(lambda m: m.MultiHeadAttention(D, NH))
    _check(jl, tl, _n(B, S, D), _masks()[mask])


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post", "pre"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer_matches_reference(pre_norm, activation):
    jl, tl = _pair(lambda m: m.TransformerEncoderLayer(
        D, NH, FF, dropout=0.0, activation=activation,
        normalize_before=pre_norm))
    _check(jl, tl, _n(B, S, D), _masks()["bool"])


def test_two_layer_encoder_matches_reference():
    def build(m):
        layer = m.TransformerEncoderLayer(D, NH, FF, dropout=0.0)
        return m.TransformerEncoder(layer, 2, norm=m.LayerNorm(D))
    jl, tl = _pair(build)
    _check(jl, tl, _n(B, S, D), _masks()["float"])


def _qkv(seed=0):
    return [torch.from_numpy(_n(2, 8, 2, 4, seed=seed + i)) for i in range(3)]


def test_attention_dropout_through_call_op():
    """p 0.5: about half the probabilities kept, each scaled by 2 (the
    output is ``probs' @ v`` with v the identity, so it shows probs')."""
    q, k, _ = _qkv()
    v = torch.eye(8)[None, :, None, :].expand(2, 8, 2, 8).contiguous()
    port_seed(0)
    state = torch.random.get_rng_state()
    plain = call_op("scaled_dot_product_attention", q, k, v)
    dropped = call_op("scaled_dot_product_attention", q, k, v,
                      dropout_p=0.5)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert not torch.equal(plain, dropped)
    kept = dropped != 0
    assert 0.4 < float(kept.float().mean()) < 0.6
    torch.testing.assert_close(dropped[kept], 2 * plain[kept])
    port_seed(0)
    again = call_op("scaled_dot_product_attention", q, k, v, dropout_p=0.5)
    assert torch.equal(again, dropped)


def test_attention_dropout_zero_is_the_identity():
    q, k, v = _qkv(3)
    for name in ("scaled_dot_product_attention", "flash_attention"):
        plain = call_op(name, q, k, v)
        assert torch.equal(call_op(name, q, k, v, dropout_p=0.0), plain)


def test_encoder_copies_draw_different_dropout_masks():
    """A deep copy clones its original's generator state; the encoder
    reseeds each copy's Dropouts, so layers 0 and 1 differ."""
    port_seed(0)
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        D, NH, FF, dropout=0.5, attn_dropout=0.0), 2)
    gens = [m.generator for m in enc.modules()
            if isinstance(m, tnn.Dropout)]
    assert len(gens) == 6 and len({id(g) for g in gens}) == 6
    x = torch.ones(1, 64)
    d0, d1 = enc.layers[0].dropout1, enc.layers[1].dropout1
    assert not torch.equal(d0(x), d1(x))
    # an original and its plain deep copy would agree: the copy's
    # generator state is the original's
    import copy
    twin = copy.deepcopy(d0)
    assert torch.equal(d0(x), twin(x))
