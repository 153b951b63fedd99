"""The port's linalg, fft and signal entries (``ops/kernels/linalg_fft.py``
and the extras of ``extra_misc.py``) against the JAX package's, on the
CPU, through ``tests/_torch_op_check.py``: forward and, where the
reference differentiates the op, the VJP of every floating or complex
input (complex outputs under complex cotangents).

Tolerances: atol / rtol 1e-4 for the decompositions and solves (float32
LAPACK on both sides, different blockings), 1e-5 for the fft family and
the signal composites, whose values are sums of a few hundred terms.

The decompositions are unique only up to the sign (or phase) of each
vector: ``svd``, ``qr`` and ``eigh`` are held by invariants (the
reconstruction, orthogonality, the sorted values against the reference's,
``|u_i . u'_i| = 1``), and their gradients through functions that do not
see the signs (``U * U``, ``Q * Q``, ``R * R``, ``V * V``) on matrices
with well-separated spectra. ``eig`` and ``eigvals`` run numpy on the
host in both packages, so they are compared as values, dtype included
(real where every eigenvalue is real). ``householder_product`` has no
VJP in JAX: its forward only. The three namespaces' ``__all__`` equal
the reference's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.core.tensor import Tensor as RTensor
from paddle_tpu.ops import dispatcher as rdisp
from paddle_tpu_torch.core.device import set_device
from paddle_tpu_torch.ops import dispatcher as tdisp

from _torch_op_check import check_op

DEC = dict(atol=1e-4, rtol=1e-4)
FFT = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    set_device("cpu")
    yield
    set_device(None)


def _r(seed):
    return np.random.RandomState(seed)


def normal(*shape, seed=0):
    return _r(seed).randn(*shape).astype(np.float32)


def cnormal(*shape, seed=0):
    r = _r(seed)
    return (r.randn(*shape) + 1j * r.randn(*shape)).astype(np.complex64)


def spd(n, seed=0):
    a = normal(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def separated(n, seed=0, sym=True, m=None):
    """A matrix with singular values (eigenvalues) 1..n, well apart."""
    r = _r(seed)
    q1, _ = np.linalg.qr(r.randn(m or n, n))
    q2, _ = np.linalg.qr(r.randn(n, n))
    s = np.diag(np.arange(1.0, n + 1.0))
    return ((q2 @ s @ q2.T) if sym else (q1 @ s @ q2.T)).astype(np.float32)


A4 = normal(4, 4) + 4 * np.eye(4, dtype=np.float32)
# a rotation block: two complex eigenvalues
ROT = (np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 2, 1], [0, 0, 0, 3]],
                np.float32) + 0.1 * normal(4, 4, seed=9))


def _cases():
    c = {}
    c["det"] = ("det", [normal(3, 4, 4)], {})
    c["slogdet"] = ("slogdet", [normal(3, 4, 4, seed=1)], {})
    c["pinv"] = ("pinv", [normal(4, 3)], {})
    c["pinv_hermitian"] = ("pinv", [spd(4)], dict(hermitian=True))
    c["matrix_power_3"] = ("matrix_power", [A4], dict(n=3))
    c["matrix_power_neg"] = ("matrix_power", [A4], dict(n=-2))
    c["solve"] = ("solve", [A4, normal(4, 2, seed=2)], {})
    c["solve_batch"] = ("solve", [normal(2, 3, 3) + 3 * np.eye(
        3, dtype=np.float32), normal(2, 3, 2, seed=3)], {})
    c["cholesky_solve"] = ("cholesky_solve", [
        normal(4, 2, seed=4), np.linalg.cholesky(spd(4)).astype(np.float32)],
        {})
    c["cholesky_solve_upper"] = ("cholesky_solve", [
        normal(4, 2, seed=4), np.linalg.cholesky(spd(4)).T.copy()],
        dict(upper=True))
    c["cond"] = ("cond", [A4], {})
    c["cond_fro"] = ("cond", [A4], dict(p="fro"))
    c["cond_2"] = ("cond", [normal(2, 4, 4) + 3 * np.eye(
        4, dtype=np.float32)], dict(p=2))
    c["cond_minus_2"] = ("cond", [A4], dict(p=-2))
    c["cov"] = ("cov", [normal(3, 6)], {})
    c["cov_cols_ddof0"] = ("cov", [normal(6, 3)], dict(rowvar=False,
                                                       ddof=False))
    c["cov_weights"] = ("cov", [normal(3, 6), True, True, np.array(
        [1, 2, 1, 3, 1, 1], np.int64), np.abs(normal(6, seed=5)) + 0.1], {})
    c["corrcoef"] = ("corrcoef", [normal(3, 6)], {})
    c["corrcoef_cols"] = ("corrcoef", [normal(6, 3)], dict(rowvar=False))
    c["multi_dot"] = ("multi_dot", [[normal(3, 4), normal(4, 5, seed=1),
                                     normal(5, 2, seed=2)]], {})
    for p in ("fro", "nuc", 1, -1, 2, -2, float("inf")):
        c[f"matrix_norm_{p}"] = ("matrix_norm", [normal(2, 3, 4)],
                                 dict(p=p))
    c["matrix_norm_axes"] = ("matrix_norm", [normal(3, 2, 4)],
                             dict(axis=[0, 2], keepdim=True))
    c["matrix_norm_nuc_axes"] = ("matrix_norm", [normal(3, 2, 4)],
                                 dict(p="nuc", axis=[2, 0], keepdim=True))
    c["lstsq"] = ("lstsq", [normal(6, 4), normal(6, 2, seed=1)], {})
    c["lstsq_vec"] = ("lstsq", [normal(6, 4), normal(6, seed=1)], {})
    c["lstsq_rcond"] = ("lstsq", [np.concatenate(
        [normal(6, 3), normal(6, 1, seed=2)[:, [0, 0]]], 1),
        normal(6, 2, seed=1)], dict(rcond=1e-3))
    c["lu"] = ("lu", [normal(2, 4, 4)], {})
    c["eigvalsh"] = ("eigvalsh", [spd(4)], {})
    c["eigvalsh_upper"] = ("eigvalsh", [normal(4, 4)], dict(UPLO="U"))
    c["eig_complex"] = ("eig", [ROT], {})
    c["eig_real"] = ("eig", [spd(4)], {})
    c["eigvals"] = ("eigvals", [normal(4, 4, seed=3)], {})
    c["matrix_rank"] = ("matrix_rank", [normal(2, 4, 4)], {})
    c["matrix_rank_deficient"] = ("matrix_rank", [np.concatenate(
        [normal(5, 3), np.zeros((5, 2), np.float32)], 1)], {})
    c["matrix_rank_tol"] = ("matrix_rank", [normal(3, 4, 4)],
                            dict(tol=np.float32(0.5)))
    c["matrix_rank_hermitian"] = ("matrix_rank", [spd(4)],
                                  dict(hermitian=True))
    c["matrix_rank_complex"] = ("matrix_rank", [cnormal(2, 4, 4)], {})
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_linalg_entry(case):
    name, args, kw = CASES[case]
    check_op(name, args, kw, **DEC)


def test_householder_product_forward():
    # JAX has no differentiation rule for householder_product
    check_op("householder_product", [normal(5, 3), normal(3, seed=1)],
             grad=False, **DEC)


def test_lu_unpack_round_trip():
    x = normal(2, 5, 5)
    lu, piv = tdisp.call_op("lu", torch.from_numpy(x))
    p, l, u = tdisp.call_op("lu_unpack", lu, piv)
    np.testing.assert_allclose((p @ l @ u).numpy(), x, atol=1e-5)
    r_lu, r_piv = rdisp.call_op("lu", RTensor(x))
    for got, want in zip((p, l, u), rdisp.call_op("lu_unpack", r_lu, r_piv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **DEC)
    assert piv.dtype == torch.int32 and int(piv.min()) >= 1


def test_lu_unpack_rectangular():
    x = normal(4, 6)
    lu, piv = rdisp.call_op("lu", RTensor(x))
    check_op("lu_unpack", [lu.numpy(), piv.numpy()], **DEC)


def test_eig_dtype_follows_numpy():
    w, _ = tdisp.call_op("eig", torch.from_numpy(spd(4)))
    assert w.dtype == torch.float32
    w, _ = tdisp.call_op("eig", torch.from_numpy(ROT))
    assert w.dtype == torch.complex64


# -- decompositions by invariants ---------------------------------------------

def _ref(name, *args, **kw):
    return rdisp.call_op(name, *[RTensor(a) for a in args], **kw)


@pytest.mark.parametrize("shape,full", [((5, 3), False), ((3, 5), False),
                                        ((2, 4, 4), False), ((5, 3), True)])
def test_svd_invariants(shape, full):
    x = normal(*shape)
    u, s, vh = tdisp.call_op("svd", torch.from_numpy(x), full_matrices=full)
    k = min(shape[-2:])
    rec = u[..., :k] * s[..., None, :] @ vh[..., :k, :]
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5)
    eye = np.broadcast_to(np.eye(u.shape[-1]), u.shape[:-2] + (u.shape[-1],)
                          * 2)
    np.testing.assert_allclose((u.mT @ u).numpy(), eye, atol=1e-5)
    ru, rs, rvh = _ref("svd", x, full_matrices=full)
    np.testing.assert_allclose(s.numpy(), rs.numpy(), **DEC)
    dots = np.abs((u.numpy()[..., :k] * ru.numpy()[..., :k]).sum(-2))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_invariants(mode):
    x = normal(5, 3)
    q, r = tdisp.call_op("qr", torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose((q @ r).numpy(), x, atol=1e-5)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(q.shape[1]),
                               atol=1e-5)
    rq, rr = _ref("qr", x, mode=mode)
    np.testing.assert_allclose(np.abs(r.numpy()), np.abs(rr.numpy()), **DEC)


def test_eigh_invariants():
    x = separated(5, seed=3)
    w, v = tdisp.call_op("eigh", torch.from_numpy(x))
    np.testing.assert_allclose((v * w[None, :] @ v.T).numpy(), x, atol=1e-5)
    rw, rv = _ref("eigh", x)
    np.testing.assert_allclose(w.numpy(), rw.numpy(), **DEC)
    dots = np.abs((v.numpy() * rv.numpy()).sum(0))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def _sign_free_grads(name, x, kw, pick):
    """The gradient of ``sum(ct_i * pick(outputs)_i)`` in both packages,
    ``pick`` a sign-free function of the decomposition's outputs."""
    rng = _r(7)
    rt = RTensor(x, stop_gradient=False)
    r_parts = pick(rdisp.call_op(name, rt, **kw))
    cts = [rng.randn(*p.shape).astype(np.float32) for p in r_parts]
    loss = None
    for p, ct in zip(r_parts, cts):
        term = (p * RTensor(ct)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    pt = torch.from_numpy(x.copy()).requires_grad_(True)
    p_parts = pick(tdisp.call_op(name, pt, **kw))
    sum((p * torch.from_numpy(ct)).sum()
        for p, ct in zip(p_parts, cts)).backward()
    return pt.grad.numpy(), rt.grad.numpy()


@pytest.mark.parametrize("name,shape,kw,pick", [
    ("svd", (5, 4), {}, lambda o: (o[0] * o[0], o[1], o[2] * o[2])),
    ("eigh", (4, 4), {}, lambda o: (o[0], o[1] * o[1])),
    ("qr", (5, 4), {}, lambda o: (o[0] * o[0], o[1] * o[1])),
])
def test_decomposition_grads_separated(name, shape, kw, pick):
    x = separated(shape[1], seed=2, sym=name == "eigh", m=shape[0])
    if name == "qr":
        x = x + 3 * np.eye(*shape, dtype=np.float32)
    got, want = _sign_free_grads(name, x, kw, pick)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


# -- fft ----------------------------------------------------------------------

def _fft_cases():
    c = {}
    x, z = normal(3, 8), cnormal(3, 8)
    c["fft"] = ("fft", [x], {})
    c["fft_complex_n"] = ("fft", [z], dict(n=6, axis=0))
    c["ifft"] = ("ifft", [z], dict(norm="ortho"))
    c["rfft_n"] = ("rfft", [x], dict(n=10))
    c["irfft"] = ("irfft", [cnormal(3, 5)], {})
    c["irfft_n"] = ("irfft", [cnormal(3, 5)], dict(n=9, norm="forward"))
    c["hfft"] = ("hfft", [cnormal(3, 5)], {})
    c["ihfft"] = ("ihfft", [x], {})
    c["fft_bad_norm"] = ("fft", [x], dict(norm="unknown"))
    c["fft2"] = ("fft2", [normal(2, 4, 6)], dict(norm="ortho"))
    c["ifft2"] = ("ifft2", [cnormal(2, 4, 6)], dict(norm="forward"))
    c["rfft2"] = ("rfft2", [normal(2, 4, 6)], {})
    c["rfft2_s"] = ("rfft2", [normal(2, 4, 6)], dict(s=[3, 8]))
    c["irfft2"] = ("irfft2", [cnormal(2, 4, 4)], {})
    c["fftn"] = ("fftn", [normal(2, 4, 6)], {})
    c["ifftn_axes"] = ("ifftn", [cnormal(2, 4, 6)], dict(s=[3, 5],
                                                         axes=[0, 2]))
    c["fftshift"] = ("fftshift", [normal(4, 5)], {})
    c["ifftshift_axis"] = ("ifftshift", [normal(4, 5)], dict(axes=[1]))
    c["fftfreq"] = ("fftfreq", [], dict(n=7, d=0.5))
    c["rfftfreq"] = ("rfftfreq", [], dict(n=8, dtype="float64"))
    c["fft_c2c"] = ("fft_c2c", [z], dict(axes=[0, 1]))
    c["fft_c2c_inverse"] = ("fft_c2c", [z], dict(forward=False,
                                                 normalization="ortho"))
    c["fft_r2c"] = ("fft_r2c", [x], {})
    c["fft_r2c_twosided"] = ("fft_r2c", [x], dict(onesided=False))
    c["fft_c2r"] = ("fft_c2r", [cnormal(3, 5)], dict(last_dim_size=8))
    c["fft_c2r_default"] = ("fft_c2r", [cnormal(3, 5)], {})
    # signal
    c["frame"] = ("frame", [normal(2, 40)], dict(frame_length=8,
                                                 hop_length=4))
    c["frame_axis0"] = ("frame", [normal(40, 3)], dict(
        frame_length=8, hop_length=5, axis=0))
    c["stft_1d"] = ("stft", [normal(300)], dict(n_fft=64))
    c["stft_window_short"] = ("stft", [
        normal(2, 300), 64, 20, 48, np.hanning(48).astype(np.float32)],
        dict(normalized=True))
    c["stft_3d_twosided"] = ("stft", [normal(2, 2, 300)], dict(
        n_fft=32, onesided=False, pad_mode="constant"))
    c["stft_4d_reflect"] = ("stft", [normal(2, 1, 2, 200)], dict(n_fft=32))
    c["stft_no_center"] = ("stft", [normal(2, 300)], dict(n_fft=64,
                                                          center=False))
    c["istft"] = ("istft", [cnormal(2, 33, 10)], dict(n_fft=64,
                                                      hop_length=16))
    c["istft_window_length"] = ("istft", [
        cnormal(33, 12), 64, 16, 40, np.hanning(40).astype(np.float32)],
        dict(length=150, normalized=True))
    c["istft_twosided_complex"] = ("istft", [cnormal(2, 32, 9)], dict(
        n_fft=32, onesided=False, return_complex=True))
    c["istft_no_center"] = ("istft", [cnormal(17, 9)], dict(
        n_fft=32, hop_length=8, center=False))
    # a window the NOLA check refuses: the envelope's zeros clamp at 1e-11
    c["istft_nola_gap"] = ("istft", [
        cnormal(17, 5), 32, 32, 32, np.hanning(32).astype(np.float32)], {})
    return c


FFT_CASES = _fft_cases()


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_signal_entry(case):
    name, args, kw = FFT_CASES[case]
    tol = DEC if case == "istft_nola_gap" else FFT
    check_op(name, args, kw, **tol)


# c2r inputs: (spectrum, output lengths s or None, axes)
C2R_CASES = {
    "1d": (cnormal(3, 5), None, [-1]),
    "1d_odd": (cnormal(3, 5), [9], [-1]),
    "1d_cut": (cnormal(3, 5), [6], [-1]),
    "1d_padded": (cnormal(3, 5), [12], [-1]),
    "2d": (cnormal(2, 4, 5), None, [-2, -1]),
    "2d_cut": (cnormal(2, 4, 5), [3, 7], [-2, -1]),
    "2d_padded": (cnormal(2, 4, 5), [6, 10], [-2, -1]),
    "3d": (cnormal(3, 4, 5), None, [0, 1, 2]),
    "axes_0_2": (cnormal(4, 3, 5), None, [0, 2]),
}


def _full_reading_inverse(half, s, dims):
    """The inverse of a half spectrum by an FFT that reads every bin: the
    spectrum extended by its Hermitian mirror, then a complex ``ifftn``.
    Where the half spectrum is not a real signal's, the result has an
    imaginary part and its real part depends on the DC and Nyquist
    columns' imaginary parts, as cuFFT's c2r does."""
    dims = [d % half.ndim for d in dims]
    last, lead, n = dims[-1], dims[:-1], s[-1]
    tail = np.take(half, np.arange(1, (n + 1) // 2), axis=last)
    if lead:
        tail = np.roll(np.flip(tail, lead), [1] * len(lead), lead)
    full = np.concatenate([half, np.flip(np.conj(tail), last)], last)
    return np.fft.ifftn(full, axes=dims)


@pytest.mark.parametrize("case", sorted(C2R_CASES))
def test_c2r_half_spectrum_is_the_references(case):
    """``hermitian_half`` makes any half spectrum a real signal's whose
    inverse is the reference's ``irfftn``: an FFT that reads every bin (as
    cuFFT's c2r does) then agrees with JAX, where on the raw spectrum it
    does not."""
    import jax.numpy as jnp
    from paddle_tpu_torch.ops.kernels.linalg_fft import _fit, hermitian_half
    x, s, dims = C2R_CASES[case]
    want = np.asarray(jnp.fft.irfftn(x, s=s, axes=dims))
    half, s_out = hermitian_half(torch.from_numpy(x), s, dims)
    assert list(s_out) == list(want.shape[d] for d in dims)
    got = _full_reading_inverse(half.numpy().astype(np.complex128), s_out,
                                dims)
    np.testing.assert_allclose(got.imag, 0, atol=1e-6)
    np.testing.assert_allclose(got.real, want, **FFT)
    # the raw spectrum (only cut or padded) is no real signal's: read
    # whole, it gives another answer
    raw = torch.from_numpy(x)
    for d, size in zip(dims, list(s_out[:-1]) + [s_out[-1] // 2 + 1]):
        raw = _fit(raw, d, size)
    assert np.abs(_full_reading_inverse(raw.numpy(), s_out, dims)
                  - want).max() > 1e-3


def test_istft_inverts_stft():
    x = torch.from_numpy(normal(3, 4096))
    w = torch.hann_window(256, periodic=True)
    spec = tdisp.call_op("stft", x, 256, 64, window=w)
    back = tdisp.call_op("istft", spec, 256, 64, window=w)
    assert float((back - x).abs().max()) <= 1e-5 * float(x.abs().max())


def test_namespaces_match_the_reference():
    import paddle_tpu_torch as P
    for name in ("linalg", "fft", "signal"):
        assert sorted(getattr(P, name).__all__) == \
            sorted(getattr(paddle_tpu, name).__all__), name
    # the fft and signal functions live only in their namespaces
    assert isinstance(P.fft, type(P.linalg))
    for name in ("rfft", "fftshift", "stft", "istft", "frame"):
        assert not hasattr(P, name), name
        assert name not in P.__all__


def test_namespace_boundary_rule():
    import paddle_tpu_torch as P
    x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
    t = torch.from_numpy(x)
    assert type(P.linalg.det(t)) is torch.Tensor
    assert type(P.fft.rfft(t)) is torch.Tensor
    pt = P.to_tensor(x)
    assert isinstance(P.linalg.det(pt), P.Tensor)
    w, v = P.linalg.eig(pt)              # computed on the host
    assert isinstance(w, P.Tensor) and isinstance(v, P.Tensor)
    assert isinstance(P.signal.stft(P.to_tensor(normal(200)), 32), P.Tensor)
    assert isinstance(pt.det(), P.Tensor)
