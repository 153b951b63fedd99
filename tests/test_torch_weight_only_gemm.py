"""The port's weight-only GEMM against the JAX package's, at a small size.

Inputs are numpy arrays from a seed, handed to both packages. The JAX side
runs eagerly (not jitted: this CPU's XLA refuses the per-channel int4
route's bf16 x bf16 -> float32 dot under ``jax.jit``), and its Pallas
kernel ``_pallas_int4_matmul`` in interpret mode at shapes it takes here;
the port takes its plain versions for CPU tensors. Held to the reference:

- ``quantize`` (int8 and int4, per channel and per group of 16 and 32, from
  float32 and bf16 weights): ``qweight`` and scales bitwise equal to the
  JAX ``quantize`` jitted, as the reference's ``weight_quantize`` op runs
  it (XLA multiplies by the bound's float32 reciprocal where the eager
  function divides); ``dequantize`` bitwise equal; an odd k raises for
  int4;
- ``weight_only_matmul`` on all four routes (int8/int4 x per channel/per
  group), float32 and bf16 x, and ``int4_matmul_plain`` against the Pallas
  kernel: a float32 output within 1e-5 of the output's absmax (the same
  exact bf16 x int products, summed in another order); a bf16 output
  within one bf16 ulp (both round a float32 value once);
- ``weight_only_linear`` with a bias and a 3-D x, the same way.

Routing: a CPU tensor takes the plain version; any other device launches
the kernel wrapper, which raises where there is no kernel, unless
``FLAGS_use_pallas_kernels`` is off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.kernels import quant as jquant
from paddle_tpu.ops.kernels.pallas import weight_only_gemm as jwog
from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels import quant as tquant
from paddle_tpu_torch.ops.kernels import weight_only_gemm as twog

M, K, N = 7, 96, 80
ROUTES = [("int8", -1), ("int8", 16), ("int4", -1), ("int4", 32)]
# the reference's weight_quantize op, as call_op runs it: jitted
jquantize = jax.jit(jwog.quantize, static_argnums=(1, 2))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-38))) - 7), 0.0)
    return bool((np.abs(got - want) <= ulp).all())


def _assert_matches(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert _within_one_bf16_ulp(got, want)


def _quantized(weight_dtype, group_size, k=K, n=N, seed=1):
    """The same weight quantized by both packages."""
    w = _rand(k, n, seed=seed, scale=0.05)
    jq, js = jquantize(jnp.asarray(w), weight_dtype, group_size)
    tq, ts = twog.quantize(torch.from_numpy(w), weight_dtype, group_size)
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("w_dtype", sorted(DTYPES))
@pytest.mark.parametrize("weight_dtype,group_size",
                         ROUTES + [("int4", 16), ("int8", 32)])
def test_quantize_and_dequantize_bitwise(weight_dtype, group_size, w_dtype):
    w = _rand(K, N, seed=2, scale=0.05)
    jdt, tdt = DTYPES[w_dtype]
    jq, js = jquantize(jnp.asarray(w, jdt), weight_dtype, group_size)
    tq, ts = twog.quantize(torch.from_numpy(w).to(tdt), weight_dtype,
                           group_size)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    int4 = weight_dtype == "int4"
    assert tuple(tq.shape) == ((K // 2, N) if int4 else (K, N))
    np.testing.assert_array_equal(
        twog.dequantize(tq, ts, int4, N).numpy(),
        np.asarray(jwog.dequantize(jq, js, int4, N)))
    algo = f"weight_only_{weight_dtype}"
    np.testing.assert_array_equal(
        tquant.weight_dequantize(tq, ts, algo, "float32").numpy(),
        np.asarray(jquant.weight_dequantize_kernel(jq, js, algo, "float32")))


def test_int4_nibbles_unpack_to_the_codes():
    """Every code -8..7 in both nibbles survives the pack and the
    sign-extending unpack."""
    codes = np.array(np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
                     ).reshape(2, -1).T.reshape(-1, 1)        # [512, 1]
    packed = ((codes[1::2] & 0xF) << 4 | (codes[0::2] & 0xF)).astype(
        np.uint8).view(np.int8)
    got = twog._unpack_int4(torch.from_numpy(packed), 1).numpy()
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(
        got, np.asarray(jwog._unpack_int4(jnp.asarray(packed), 1)))


def test_int4_odd_k_raises():
    with pytest.raises(ValueError, match="even k"):
        twog.quantize(torch.zeros(5, 4), "int4")


@pytest.mark.parametrize("x_dtype", sorted(DTYPES))
@pytest.mark.parametrize("weight_dtype,group_size", ROUTES)
def test_weight_only_matmul_matches_reference(weight_dtype, group_size,
                                              x_dtype):
    (jq, js), (tq, ts) = _quantized(weight_dtype, group_size)
    x = _rand(M, K, seed=3)
    jdt, tdt = DTYPES[x_dtype]
    want = jwog.weight_only_matmul(jnp.asarray(x, jdt), jq, js,
                                   weight_dtype, group_size)
    got = twog.weight_only_matmul(_t(x, tdt), tq, ts, weight_dtype,
                                  group_size)
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    _assert_matches(got.float().numpy(), _np(want), x_dtype)


@pytest.mark.parametrize("x_dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(16, 512, 640), (5, 256, 256)])
def test_int4_plain_matches_pallas_kernel(m, k, n, x_dtype):
    (jq, js), (tq, ts) = _quantized("int4", -1, k, n, seed=4)
    x = _rand(m, k, seed=5)
    jdt, tdt = DTYPES[x_dtype]
    want = jwog._pallas_int4_matmul(jnp.asarray(x, jdt), jq, js, bn=128,
                                    bk2=128)
    got = twog.int4_matmul_plain(_t(x, tdt), tq, ts)
    assert got.dtype == tdt
    _assert_matches(got.float().numpy(), _np(want), x_dtype)


@pytest.mark.parametrize("x_dtype", sorted(DTYPES))
@pytest.mark.parametrize("weight_dtype,group_size", [("int4", -1),
                                                     ("int8", 32)])
def test_weight_only_linear_with_bias_and_3d_x(weight_dtype, group_size,
                                               x_dtype):
    (jq, js), (tq, ts) = _quantized(weight_dtype, group_size)
    x = _rand(2, 3, K, seed=6)
    bias = _rand(N, seed=7, scale=0.1)
    jdt, tdt = DTYPES[x_dtype]
    want = jquant.weight_only_linear_kernel(
        jnp.asarray(x, jdt), jq, jnp.asarray(bias), js,
        weight_dtype=weight_dtype, group_size=group_size)
    got = tquant.weight_only_linear(_t(x, tdt), tq, torch.from_numpy(bias),
                                    ts, weight_dtype=weight_dtype,
                                    group_size=group_size)
    assert got.dtype == tdt and tuple(got.shape) == (2, 3, N)
    _assert_matches(got.float().numpy(), _np(want), x_dtype)


def test_routing_cpu_plain_other_devices_the_kernel_or_the_flag():
    _, (tq, ts) = _quantized("int4", -1)
    x = _t(_rand(M, K, seed=8))
    np.testing.assert_array_equal(
        twog.weight_only_matmul(x, tq, ts, "int4").numpy(),
        twog.int4_matmul_plain(x, tq, ts).numpy())
    meta = [t.to("meta") for t in (x, tq, ts)]
    with pytest.raises(ValueError, match="no kernel"):
        twog.weight_only_matmul(*meta, "int4")
    prev = flags.get_flag("use_pallas_kernels")
    try:
        flags.set_flags({"FLAGS_use_pallas_kernels": False})
        out = twog.weight_only_matmul(*meta, "int4")   # the plain version
        assert out.device.type == "meta" and tuple(out.shape) == (M, N)
    finally:
        flags.set_flags({"FLAGS_use_pallas_kernels": prev})
    before = twog.launches.count
    twog.weight_only_matmul(x, tq, ts, "int4")
    assert twog.launches.count == before, "a CPU tensor launched nothing"
