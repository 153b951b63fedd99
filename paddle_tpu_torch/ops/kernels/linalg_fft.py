"""The decompositions, the fft family and the signal composites.

Counterparts of ``paddle_tpu/ops/kernels/linalg_fft.py`` (``ops.yaml``
lines 372-417). The reference lowers them to XLA's decomposition and FFT
operations; here they are ``torch.linalg`` (cuSOLVER on the card) and
``torch.fft`` (cuFFT), with the reference's conventions where torch's own
functions differ:

- every SVD on the card runs cuSOLVER's ``gesvd`` (``svd_on``): torch's
  default there, ``gesvdj``, leaves a relative residual of 6.5e-5 on a
  batch of 64 float32 256 x 256 matrices and 1.0e-3 on a 4096 x 14336
  one, where ``gesvd`` reaches 2.7e-6 and 1.3e-5 (``tools/svd_drivers.py``
  on an H100, 700 W; ``gesvd`` takes 1.1-4.3x as long); ``pinv`` (but the
  Hermitian one), ``matrix_norm``'s and
  ``cond``'s spectral orders and ``lstsq`` read their singular values
  from it, ``matrix_rank`` too (``extra_misc.py``);
- ``lu`` returns 1-based int32 pivots (LAPACK's, which torch returns as
  they are and the reference makes from JAX's 0-based ones);
- ``eig`` and ``eigvals`` run numpy on the host, as the reference does,
  and return numpy's dtype on the input's device: real where every
  eigenvalue is real, complex otherwise (``torch.linalg.eig`` is always
  complex);
- ``lstsq`` is the reference's SVD solve (JAX's ``lstsq``: singular
  values under ``rcond * s[0]`` dropped, the residuals always returned),
  whatever ``driver`` says: torch's CUDA driver returns no residuals, rank
  or singular values;
- ``eigh``, ``eigvalsh`` and a Hermitian ``pinv`` symmetrize their input,
  as JAX's ``eigh`` does, and ``cholesky_solve`` reads only the factor's
  triangle, as JAX's ``cho_solve`` does: their gradients are JAX's;
- ``cov`` binds by the schema's order (``x, rowvar, ddof, fweights,
  aweights``), which the reference's kernel takes in another;
- the c2r transforms (``irfft``, ``hfft``, ``irfft2``, ``istft``'s
  inverse and ``extra_misc.fft_c2r``) read a half spectrum the way
  pocketfft (JAX's and torch's CPU FFT) reads it: the imaginary parts of
  the DC column, and of the Nyquist column where the last length is even,
  dropped after the transform over the other axes (``hermitian_half``).
  cuFFT reads those parts otherwise: on random half spectra the card gave
  results 2.4% away from the CPU's (H100, 700 W) before this;
- ``frame``, ``stft`` and ``istft`` are the reference's composites, not
  ``torch.stft`` / ``torch.istft``: gather framing, the window padded to
  ``n_fft`` in the centre, the layout ``[..., n_fft // 2 + 1, n_frames]``,
  and ``istft``'s overlap-add divided by the window envelope clamped at
  1e-11 (``torch.istft`` raises on a window that fails its NOLA check).
  The overlap-add is ``F.fold`` (col2im, no atomics), so the card's
  ``istft`` gives the same bits run to run.

``matrix_rank`` is ``extra_misc.py``'s: the reference registers it twice
and its registry holds that module's version.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import dtype_of, layer_device
from ..dispatcher import register_kernel
from .manipulation import _not_captured


# -- decompositions -----------------------------------------------------------

def svd_on(x, full_matrices=False):
    """``torch.linalg.svd`` with cuSOLVER's ``gesvd`` on the card (its
    default ``gesvdj`` is not accurate to float32)."""
    drv = "gesvd" if x.is_cuda else None
    return torch.linalg.svd(x, full_matrices=full_matrices, driver=drv)


def svdvals_on(x):
    return torch.linalg.svdvals(x, driver="gesvd" if x.is_cuda else None)


@register_kernel("svd")
def _svd(x, full_matrices=False):
    u, s, vh = svd_on(x, full_matrices=bool(full_matrices))
    return u, s, vh


@register_kernel("qr")
def _qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def _symmetrized(x):
    """``(x + x^H) / 2``: JAX's ``eigh`` symmetrizes its input (so ``UPLO``
    never matters and the gradient is symmetric); so does the port."""
    return (x + x.mH) / 2


@register_kernel("eigh")
def _eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(_symmetrized(x), UPLO=UPLO)
    return w, v


@register_kernel("eigvalsh")
def _eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(_symmetrized(x), UPLO=UPLO)


def _host(x) -> np.ndarray:
    _not_captured("eig")
    return x.detach().cpu().resolve_conj().numpy()


@register_kernel("eig")
def _eig(x):
    w, v = np.linalg.eig(_host(x))
    return (torch.from_numpy(w).to(x.device),
            torch.from_numpy(v).to(x.device))


@register_kernel("eigvals")
def _eigvals(x):
    return torch.from_numpy(np.linalg.eigvals(_host(x))).to(x.device)


@register_kernel("lu")
def _lu(x):
    lu, piv = torch.linalg.lu_factor(x)
    return lu, piv.to(torch.int32)


@register_kernel("det")
def _det(x):
    return torch.linalg.det(x)


@register_kernel("slogdet")
def _slogdet(x):
    sign, logabsdet = torch.linalg.slogdet(x)
    return sign, logabsdet


@register_kernel("pinv")
def _pinv(x, rcond=1e-15, hermitian=False):
    """JAX's ``pinv``: singular values under ``rcond * max(s)`` dropped."""
    if hermitian:
        return torch.linalg.pinv(_symmetrized(x), rtol=float(rcond),
                                 hermitian=True)
    u, s, vh = svd_on(x)
    cut = float(rcond) * s.amax(dim=-1, keepdim=True)
    s_inv = torch.where(s > cut, 1.0 / torch.where(s > cut, s,
                                                   torch.ones_like(s)),
                        torch.zeros_like(s)).to(x.dtype)
    return vh.mH @ (s_inv[..., :, None] * u.mH)


@register_kernel("matrix_power")
def _matrix_power(x, n=1):
    return torch.linalg.matrix_power(x, int(n))


@register_kernel("solve")
def _solve(x, y):
    return torch.linalg.solve(x, y)


@register_kernel("lstsq")
def _lstsq(x, y, rcond=None, driver=None):
    """JAX's ``lstsq`` (a 2-D ``x``; ``y`` ``[M]`` or ``[M, K]``):
    ``(solution, residuals, rank int32, singular values)``."""
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    m, n = x.shape
    eps = torch.finfo(x.real.dtype if x.is_complex() else x.dtype).eps
    rc = eps * max(m, n) if rcond is None else \
        (eps if float(rcond) < 0 else float(rcond))
    u, s, vh = svd_on(x)
    mask = (s > 0) & (s >= rc * s[0])
    rank = mask.sum().to(torch.int32)
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s)).to(x.dtype)[:, None]
    sol = vh.conj().T @ (s_inv * (u.conj().T @ b))
    resid = torch.linalg.vector_norm(b - x @ sol, dim=0) ** 2
    return (sol.reshape(-1) if vec else sol), resid, rank, s


@register_kernel("cholesky_solve")
def _cholesky_solve(x, y, upper=False):
    """Solves ``A z = x`` given ``y``, the Cholesky factor of ``A``: only
    its triangle is read (and differentiated), as JAX's ``cho_solve``."""
    y = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(x, y, upper=bool(upper))


@register_kernel("cond")
def _cond(x, p=None):
    if p in (None, 2, -2):
        s = svdvals_on(x)
        big, small = s[..., 0], s[..., -1]
        return small / big if p == -2 else big / small
    return torch.linalg.cond(x, p=p)


@register_kernel("cov")
def _cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    obs = x if rowvar or x.dim() < 2 else x.T
    return torch.cov(obs, correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)


@register_kernel("corrcoef")
def _corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar or x.dim() < 2 else x.T)


@register_kernel("multi_dot")
def _multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


@register_kernel("householder_product")
def _householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


@register_kernel("matrix_norm")
def _matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    axis = tuple(int(a) % x.dim() for a in axis)
    if p not in ("nuc", 2, -2):
        return torch.linalg.matrix_norm(x, ord=p, dim=axis,
                                        keepdim=bool(keepdim))
    s = svdvals_on(x.movedim(axis, (-2, -1)))
    out = s.sum(-1) if p == "nuc" else s[..., 0] if p == 2 else s[..., -1]
    if keepdim:
        for a in sorted(axis):
            out = out.unsqueeze(a)
    return out


# -- fft -----------------------------------------------------------------------

def _norm(norm):
    return norm if norm in ("forward", "ortho", "backward") else "backward"


def _s(s):
    return None if s is None else tuple(int(v) for v in s)


def _axes(axes):
    if axes is None or isinstance(axes, int):
        return axes
    return tuple(int(a) for a in axes)


def _fit(x, dim, size):
    """``x`` cut or zero-padded to ``size`` along ``dim``."""
    dim = int(dim) % x.dim()
    have = x.shape[dim]
    if have >= size:
        return x.narrow(dim, 0, size)
    pad = x.new_zeros(x.shape[:dim] + (size - have,) + x.shape[dim + 1:])
    return torch.cat([x, pad], dim)


def hermitian_half(x, s, dims):
    """The half spectrum that a c2r transform over ``dims`` reads:
    ``(x', s')`` with ``x`` cut or zero-padded to the output lengths ``s``
    (the last dim to ``s[-1] // 2 + 1``; ``s`` None: the other dims as they
    are, the last ``2 * (m - 1)``), and its DC column, and its Nyquist
    column where ``s[-1]`` is even, made Hermitian over the other dims:
    ``(c + conj(c[-k mod n])) / 2``, which is pocketfft's dropping of their
    imaginary parts after the c2c pass over those dims (over no other dim:
    the real part). ``x'`` is then a real signal's spectrum, which cuFFT
    and pocketfft transform alike."""
    dims = [int(d) % x.dim() for d in dims]
    last, lead = dims[-1], dims[:-1]
    if s is None:
        s = [x.shape[d] for d in lead] + [2 * (x.shape[last] - 1)]
    s = [int(v) for v in s]
    for d, size in zip(lead, s[:-1]):
        x = _fit(x, d, size)
    n = s[-1]
    x = _fit(x, last, n // 2 + 1)
    if not x.is_complex():
        x = torch.complex(x, torch.zeros_like(x))
    # the DC and Nyquist columns: a strided view, no copy
    cols = [slice(None)] * x.dim()
    cols[last] = slice(0, None, n // 2) if n % 2 == 0 and n > 0 else \
        slice(0, 1)
    cols = tuple(cols)
    c = x[cols]
    mirror = c.flip(lead).roll([1] * len(lead), lead) if lead else c
    out = x.clone()
    out[cols] = (c + mirror.conj()) / 2
    return out, s


def _fft1(name):
    fn = getattr(torch.fft, name)

    def kernel(x, n=None, axis=-1, norm="backward"):
        n = None if n is None else int(n)
        if name in ("irfft", "hfft"):
            x, (n,) = hermitian_half(x, None if n is None else [n], [axis])
        # ihfft returns a conjugate view: materialise it
        return fn(x, n=n, dim=int(axis), norm=_norm(norm)).resolve_conj()
    kernel.__name__ = kernel.__qualname__ = f"_{name}"
    return register_kernel(name)(kernel)


def _fftn(name):
    fn = getattr(torch.fft, name)

    def kernel(x, s=None, axes=(-2, -1), norm="backward"):
        s, dims = _s(s), _axes(axes)
        if name == "irfft2":
            if dims is None:
                dims = range(x.dim() - (2 if s is None else len(s)), x.dim())
            dims = (dims,) if isinstance(dims, int) else tuple(dims)
            x, s = hermitian_half(x, s, dims)
        return fn(x, s=s, dim=dims, norm=_norm(norm))
    kernel.__name__ = kernel.__qualname__ = f"_{name}"
    return register_kernel(name)(kernel)


for _name in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
    _fft1(_name)
for _name in ("fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn"):
    _fftn(_name)


@register_kernel("fftshift")
def _fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=_axes(axes))


@register_kernel("ifftshift")
def _ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=_axes(axes))


@register_kernel("fftfreq")
def _fftfreq(n=1, d=1.0, dtype=None):
    return torch.fft.fftfreq(int(n), d=float(d), device=layer_device()).to(
        torch.float32 if dtype is None else dtype_of(dtype))


@register_kernel("rfftfreq")
def _rfftfreq(n=1, d=1.0, dtype=None):
    return torch.fft.rfftfreq(int(n), d=float(d), device=layer_device()).to(
        torch.float32 if dtype is None else dtype_of(dtype))


# -- signal (the frame / stft / istft composites) ------------------------------

def _frame_last(x, frame_length, hop_length):
    """``[..., T]`` -> ``[..., n_frames, frame_length]`` by a gather."""
    n_frames = 1 + (x.shape[-1] - frame_length) // hop_length
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop_length +
           torch.arange(frame_length, device=x.device)[None, :])
    return x[..., idx]


@register_kernel("frame")
def _frame(x, frame_length=512, hop_length=128, axis=-1):
    """``axis=-1``: ``[..., frame_length, n_frames]``; ``axis=0``:
    ``[n_frames, frame_length, ...]`` (the reference's layouts)."""
    if axis == 0:
        framed = _frame_last(x.movedim(0, -1), frame_length, hop_length)
        return framed.movedim((-2, -1), (0, 1))
    return _frame_last(x, frame_length, hop_length).transpose(-1, -2)


_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "replicate": "replicate",
              "wrap": "circular", "circular": "circular"}


def _pad_last(x, pad, mode):
    """Pad the last dim by ``pad`` on both sides. Torch's reflect (and
    replicate / circular) padding takes only a 2-D or 3-D input: any other
    rank is reshaped to ``[1, rows, T]`` around the call."""
    tmode = _PAD_MODES.get(mode)
    if tmode is None:
        raise ValueError(f"stft: pad_mode {mode!r} unsupported")
    if tmode == "constant":
        return F.pad(x, (pad, pad))
    flat = x.reshape(1, -1, x.shape[-1])
    return F.pad(flat, (pad, pad), mode=tmode).reshape(
        x.shape[:-1] + (x.shape[-1] + 2 * pad,))


def _full_window(window, n_fft, win_length, dtype, device):
    if window is None:
        window = torch.ones(win_length, dtype=dtype, device=device)
    if win_length < n_fft:      # centre-pad the window to n_fft
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


@register_kernel("stft")
def _stft(x, n_fft=512, hop_length=None, win_length=None, window=None,
          center=True, pad_mode="reflect", normalized=False, onesided=True):
    n_fft = int(n_fft)
    hop = int(hop_length or n_fft // 4)
    win_length = int(win_length or n_fft)
    window = _full_window(window, n_fft, win_length, x.dtype, x.device)
    if center:
        x = _pad_last(x, n_fft // 2, pad_mode)
    frames = _frame_last(x, n_fft, hop) * window
    spec = torch.fft.rfft(frames, dim=-1) if onesided else \
        torch.fft.fft(frames, dim=-1)
    if normalized:
        spec = spec / float(np.sqrt(n_fft))
    return spec.transpose(-1, -2)         # [..., bins, n_frames]


def _overlap_add(frames, hop):
    """``[B, n_frames, n_fft]`` -> ``[B, n_fft + hop * (n_frames - 1)]``:
    each frame added at ``hop * i`` (col2im through ``F.fold``)."""
    b, n_frames, n_fft = frames.shape
    out_len = n_fft + hop * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop))
    return out.reshape(b, out_len)


@register_kernel("istft")
def _istft(x, n_fft=512, hop_length=None, win_length=None, window=None,
           center=True, normalized=False, onesided=True, length=None,
           return_complex=False):
    n_fft = int(n_fft)
    hop = int(hop_length or n_fft // 4)
    win_length = int(win_length or n_fft)
    window = _full_window(window, n_fft, win_length, torch.float32,
                          x.device)
    spec = x.transpose(-1, -2)            # [..., n_frames, bins]
    if normalized:
        spec = spec * float(np.sqrt(n_fft))
    if onesided:
        spec, _ = hermitian_half(spec, [n_fft], [-1])
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    else:
        frames = torch.fft.ifft(spec, dim=-1)
        frames = frames if return_complex else frames.real
    frames = frames * window
    lead, n_frames = frames.shape[:-2], frames.shape[-2]
    flat = frames.reshape((-1, n_frames, n_fft))
    if flat.is_complex():
        sig = torch.complex(_overlap_add(flat.real, hop),
                            _overlap_add(flat.imag, hop))
    else:
        sig = _overlap_add(flat, hop)
    sq = (window * window).reshape(1, 1, n_fft).expand(1, n_frames, n_fft)
    env = _overlap_add(sq, hop)[0]
    sig = (sig / env.clamp(min=1e-11)).reshape(lead + (-1,))
    out_len = sig.shape[-1]
    if center:
        sig = sig[..., n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        sig = sig[..., :int(length)]
    return sig
