"""Flash attention, forward and backward.

Replaces ``paddle_tpu/ops/kernels/pallas/flash_attention.py``: ``_fwd``
(:126), ``_bwd`` (:247, the dq and dk/dv kernels), the public
``flash_attention`` (:361) over ``[b, s, h, d]`` and ``flash_block``
(:339) over the folded ``[b*h, s, d]`` layout with a differentiable lse.
GQA maps query head h to kv head ``h // G``; K/V are never repeated in
memory. Causal masking is right-aligned (query i sees key j iff
``j <= i + sk - sq``); causal ``sq > sk`` is not the kernel's (the routing
in ``ops/kernels/nn.py`` sends it to the composite). Accumulation is
float32; the output is in q's dtype and lse is float32 ``[b, h, sq]``.

What bounds it on the H100: operations. At the training shapes (b 2, s
2048, 32/8 heads, d 128, causal) the forward is 4·b·h·s²·d/2 = 69 GFLOP
against ~100 MB of q/k/v/out, far above the card's ~295 flop/byte ridge.
The three kernels (``csrc/flash_attention.cu``: forward, dq, dk/dv) keep
the [sq, sk] scores out of device memory: each block owns 64 rows, loops
over 64-position tiles of the other side through shared memory up to the
causal horizon, and keeps its sums in registers. dk/dv loops over the G
query heads of its group, so nothing needs atomics and results are the
same bit for bit run to run. bfloat16 runs on the tensor cores
(``csrc/flash_wgmma.cuh``: bf16 tiles streamed by ``cp.async`` through a
two-stage ring, every product a ``wgmma``, probabilities and dS fed back
as two bf16 terms, softmax statistics in float32, the causal mask on
boundary tiles only); float32 runs the same three bodies in full float32
FMA on the CUDA cores (``csrc/flash_f32.cuh``: register tiles, float32
tiles streamed by ``cp.async`` through two stages, the forward over two
query heads of a GQA group at a time, the same mask policy and grid
order). Any ``sq``/``sk`` works (the tail tile is masked), where the
Pallas kernel needs multiples of 128.

The backward takes ``delta = rowsum(dout * out)`` as a plain torch op, as
the reference does; ``flash_block``'s lse cotangent folds into it as
``delta - dlse``.

Beside the kernels: ``flash_fwd_plain``/``flash_bwd_plain``, the same
functions in plain PyTorch (one float32 einsum/softmax per (batch, kv
head) group, so the card never holds all heads' [sq, sk] scores at once),
used for CPU tensors, by the tests and by ``chip_smoke.py``; and one
launch counter per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

launches_fwd = _build.LaunchCounter("flash_attention_fwd")
launches_dq = _build.LaunchCounter("flash_attention_dq")
launches_dkv = _build.LaunchCounter("flash_attention_dkv")

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_NEG = -1e30


def supported(q_shape, k_shape, causal: bool) -> bool:
    """Whether the flash path takes this case (else the composite), by
    shape only, as the reference routes: GQA heads must divide and causal
    needs ``sq <= sk``. A CUDA head_dim or dtype the kernels lack reaches
    the kernel wrapper and raises there."""
    _, sq, hq, _ = q_shape
    sk, hk = k_shape[1], k_shape[2]
    return not (hq % hk or (causal and sq > sk))


# -- plain version ------------------------------------------------------------

def _mask(sq: int, sk: int, causal: bool, device) -> Optional[torch.Tensor]:
    if not causal:
        return None
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return cols <= rows + (sk - sq)


def _scores(qg, kk, scale, mask):
    """float32 scores of one group, ``[G, sq, sk]``, masked with -1e30."""
    s = torch.matmul(qg, kk.transpose(0, 1)) * scale
    return s if mask is None else torch.where(mask, s, _NEG)


def flash_fwd_plain(q, k, v, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward over ``[B, S, H, D]`` tensors (any strides): returns
    ``(out [B, Sq, H, D] in q's dtype, lse float32 [B, H, Sq])``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    mask = _mask(Sq, Sk, causal, q.device)
    for b in range(B):
        for h in range(KV):
            hs = slice(h * G, (h + 1) * G)
            qg = q[b, :, hs].float().transpose(0, 1)           # [G, Sq, D]
            s = _scores(qg, k[b, :, h].float(), scale, mask)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            o = torch.matmul(p, v[b, :, h].float()) / l
            out[b, :, hs] = o.transpose(0, 1).to(q.dtype)
            lse[b, hs] = (m + torch.log(l))[..., 0]
    return out, lse


def flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Plain backward: the five products (s, dp, dq, dk, dv) per (batch,
    kv head) group, with ``p = exp(s - lse)`` and ``ds = p * (dp -
    delta)``. Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mask = _mask(Sq, Sk, causal, q.device)
    for b in range(B):
        for h in range(KV):
            hs = slice(h * G, (h + 1) * G)
            qg = q[b, :, hs].float().transpose(0, 1)           # [G, Sq, D]
            dog = dout[b, :, hs].float().transpose(0, 1)
            kk, vv = k[b, :, h].float(), v[b, :, h].float()    # [Sk, D]
            p = torch.exp(_scores(qg, kk, scale, mask)
                          - lse[b, hs][..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            dp = torch.matmul(dog, vv.transpose(0, 1))         # [G, Sq, Sk]
            ds = p * (dp - delta[b, hs][..., None])
            dq[b, :, hs] = (torch.matmul(ds, kk) * scale).transpose(
                0, 1).to(q.dtype)
            dk[b, :, h] = (torch.einsum("gqk,gqd->kd", ds, qg)
                           * scale).to(k.dtype)
            dv[b, :, h] = torch.einsum("gqk,gqd->kd", p, dog).to(v.dtype)
    return dq, dk, dv


# -- kernels ------------------------------------------------------------------

def _bind(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ptt_flash_fwd.argtypes = [P] * 6 + [I] * 6 + [F, I, I, P]
    lib.ptt_flash_dq.argtypes = [P] * 8 + [I] * 6 + [F, I, I, P]
    lib.ptt_flash_dkv.argtypes = [P] * 9 + [I] * 6 + [F, I, I, P]
    for fn in (lib.ptt_flash_fwd, lib.ptt_flash_dq, lib.ptt_flash_dkv):
        fn.restype = ctypes.c_int


def _strides(*ts) -> ctypes.Array:
    """(batch, head, seq) element strides of each [B, S, H, D] tensor, as
    the host array the C launchers read."""
    vals = []
    for t in ts:
        sb, ss, sh, _ = t.stride()
        vals += [sb, sh, ss]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(names, ts, like_q, like_k) -> None:
    """Every tensor on one CUDA device, [B, S, H, D] with head_dim
    contiguous and 16-byte aligned rows, in one supported dtype."""
    q = ts[0]
    for name, t in zip(names, ts):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [batch, seq, heads, head_dim], "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q's "
                             f"{q.dtype}")
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: head_dim must be contiguous and "
                             f"rows 16-byte aligned, strides {t.stride()}")
    B, Sq, H, D = q.shape
    k = ts[1]
    Sk, KV = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype}: the kernels take {DTYPES}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels take {HEAD_DIMS}")
    if KV == 0 or H % KV or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not form GQA heads")
    for name, t in zip(names, ts):
        want = like_q if name in ("q", "out", "dout", "dq") else like_k
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)}, want {want}")


def _run(fn, args, ints, scale, causal, dtype, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, *ints, float(scale), int(causal),
                _build.DTYPE_CODES[str(dtype).removeprefix("torch.")], stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")


def flash_fwd_kernel(q, k, v, causal: bool, scale: float):
    """The forward kernel over ``[B, S, H, D]`` tensors; same result as
    :func:`flash_fwd_plain`."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check(("q", "k", "v"), (q, k, v), (B, Sq, H, D), (B, Sk, KV, D))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or Sk == 0:
        return out.zero_(), lse.fill_(_NEG)
    lib = _build.load("flash_attention", _bind)
    _run(lib.ptt_flash_fwd,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr(), _strides(q, k, v, out)),
         (B, H, KV, Sq, Sk, D), scale, causal, q.dtype, q.device)
    launches_fwd.add()
    return out, lse


def _check_bwd(q, k, v, dout, lse, delta):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check(("q", "k", "v", "dout"), (q, k, v, dout), (B, Sq, H, D),
           (B, Sk, KV, D))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{B}, {H}, {Sq}] on {q.device}")
    return B, H, KV, Sq, Sk, D


def flash_dq_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The dq kernel: dq in q's layout and dtype."""
    dims = _check_bwd(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0 or dims[4] == 0:
        return dq.zero_()
    lib = _build.load("flash_attention", _bind)
    _run(lib.ptt_flash_dq,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          _strides(q, k, v, dout, dq)), dims, scale, causal, q.dtype,
         q.device)
    launches_dq.add()
    return dq


def flash_dkv_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The dk/dv kernel: (dk, dv) in k's and v's layouts and dtype."""
    dims = _check_bwd(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0 or dims[3] == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.load("flash_attention", _bind)
    _run(lib.ptt_flash_dkv,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          _strides(q, k, v, dout, dk, dv)), dims, scale, causal, q.dtype,
         q.device)
    launches_dkv.add()
    return dk, dv


def flash_bwd_kernel(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The dq kernel, then the dk/dv kernel; same result as
    :func:`flash_bwd_plain`."""
    dq = flash_dq_kernel(q, k, v, dout, lse, delta, causal, scale)
    return (dq,) + flash_dkv_kernel(q, k, v, dout, lse, delta, causal, scale)


def _dispatch(t: torch.Tensor, plain, kernel):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if t.device.type == "cpu":
        return plain
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {t.device}")
    return kernel


def flash_fwd(q, k, v, causal: bool, scale: float):
    return _dispatch(q, flash_fwd_plain, flash_fwd_kernel)(
        q, k, v, causal, scale)


def flash_bwd(q, k, v, dout, lse, delta, causal: bool, scale: float):
    return _dispatch(q, flash_bwd_plain, flash_bwd_kernel)(
        q, k, v, dout, lse, delta, causal, scale)


# -- autograd -----------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """(out, lse) over ``[B, S, H, D]`` views; saves (q, k, v, out, lse).
    lse is a differentiable output: its cotangent folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        elif dout.stride(-1) != 1:
            dout = dout.contiguous()
        # delta = rowsum(dout * out), float32 [B, H, Sq]
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = flash_bwd(q, k, v, dout, lse, delta.contiguous(),
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """``[batch, seq, heads, head_dim]`` attention, GQA-aware; scale
    defaults to ``head_dim ** -0.5``. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernels or raises."""
    if scale is None:
        scale = query.shape[-1] ** -0.5
    out, _ = _Flash.apply(query, key, value, bool(causal), float(scale))
    return out


def flash_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention block on the folded layout: q ``[bh, sq, d]``, k/v
    ``[bh_kv, sk, d]``; returns ``(out [bh, sq, d], lse [bh, sq])`` with a
    differentiable lse (the ring-attention building block)."""
    fold = lambda t: t.unsqueeze(0).transpose(1, 2)  # noqa: E731  [1, s, bh, d]
    out, lse = _Flash.apply(fold(q), fold(k), fold(v), bool(causal),
                            float(scale))
    return out[0].transpose(0, 1), lse[0]
