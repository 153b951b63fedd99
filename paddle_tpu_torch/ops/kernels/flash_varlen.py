"""Packed (varlen) flash attention, forward and backward.

Replaces ``paddle_tpu/ops/kernels/pallas/flash_varlen.py``: the forward
(``_fwd_kernel`` :44 via ``_varlen_fwd_impl`` :224), the backward
(``_dq_kernel`` :100 and ``_dkv_kernel`` :139 via ``_varlen_bwd`` :287),
``_segments`` (:187), ``_block_ranges`` (:199), ``varlen_composite``
(:383), ``same_cu_layout`` (:411) and the public ``flash_attn_unpadded``
(:429), the reference ``flash_attn_unpadded`` contract: q ``[total_q,
heads, head_dim]``, k/v ``[total_k, kv_heads, head_dim]``, ``cu_seqlens_*``
``[batch + 1]`` int32 prefix sums that start at 0 and end at the token
count.

Query token t of segment s attends key u iff u is in segment s too and,
under ``causal``, its position in the segment is at most t's (causal is
top-left inside each segment, so cross packing with ``cu_q != cu_k`` keeps
the reference's meaning). A row with no live key gives out 0 and lse
-1e30, and zero grads.

The three CUDA kernels (``csrc/flash_varlen.cu``) read q, k, v and dout
through their strides in the packed layout: no transposed or padded copy.
bfloat16 runs on the tensor cores through the engine the flash kernels
use (``csrc/flash_wgmma.cuh``), with the segment mask evaluated on
boundary tiles only and each grid walking its blocks longest run first
(``longest_first``); float32 keeps CUDA-core kernels.
The wrapper derives per-token segment ids and positions from
``cu_seqlens`` on the device (``segments``: ``torch.searchsorted``), the
segment range of every 64-token block (``block_ranges``) and from them
each block's loop bounds over the other side (``block_bounds``: the
reference's skip rule, a (q block, k block) pair runs iff their segment
ranges overlap, and under causal self packing iff the k block is not past
the q block's last token). All of it stays on the device: no per-call host
sync. ``same_cu_layout``, which decides whether the causal token-space
skip applies, compares on the host as the reference does: identity first,
then shapes and values (``torch.equal``, one small device-to-host read
when the two are different tensors). The skip changes the time only.

The backward takes ``delta = rowsum(dout * out)`` as a plain torch op, as
the reference does (:299).

Beside the kernels: ``flash_varlen_fwd_plain``/``flash_varlen_bwd_plain``,
the same functions in plain PyTorch (float32 scores per (segment, kv head)
group, so nothing ever holds the dense ``[h, Tq, Tk]`` scores), used for
CPU tensors, by the tests and by ``chip_smoke.py``; and one launch counter
per kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build

launches_fwd = _build.LaunchCounter("flash_varlen_fwd")
launches_dq = _build.LaunchCounter("flash_varlen_dq")
launches_dkv = _build.LaunchCounter("flash_varlen_dkv")

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
BLOCK = 64          # rows of a kernel block, on both sides
_NEG = -1e30


# -- layout helpers -----------------------------------------------------------

def segments(cu: torch.Tensor, total: int, pad_total: Optional[int] = None,
             pad_id: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """cu_seqlens ``[n+1]`` -> (segment id, position in the segment), both
    int32 ``[pad_total]`` on cu's device; tokens from ``total`` on are
    padding, with id ``pad_id`` and position 0."""
    pad_total = total if pad_total is None else pad_total
    cu = cu.to(torch.int32)
    t = torch.arange(pad_total, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu, t, right=True, out_int32=True) - 1
    start = cu[seg.clamp(0, cu.shape[0] - 2)]
    pad = t >= total
    return (torch.where(pad, pad_id, seg),
            torch.where(pad, 0, t - start))


def block_ranges(seg: torch.Tensor, nb: int, bsz: int) -> torch.Tensor:
    """Per-block (min, max) segment ids -> int32 ``[2, nb]``."""
    s = seg.reshape(nb, bsz)
    return torch.stack([s.amin(dim=1), s.amax(dim=1)]).to(torch.int32)


def block_bounds(rq: torch.Tensor, rk: torch.Tensor, tok_skip: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (q block, k block) pairs that run, as loop bounds: q block i
    walks k blocks ``[qb[0, i], qb[1, i]]``, k block j walks q blocks
    ``[kb[0, j], kb[1, j]]`` (empty when first > last). A pair runs iff
    the blocks' segment ranges (``rq`` ``[2, nq]``, ``rk`` ``[2, nk]``,
    both non-decreasing) overlap and, with ``tok_skip``, the k block starts
    at or before the q block's last token (blocks of one size)."""
    qlo, qhi, klo, khi = rq[0], rq[1], rk[0], rk[1]
    ss = lambda seq, x, right=False: torch.searchsorted(  # noqa: E731
        seq, x, right=right, out_int32=True)
    jlo, jhi = ss(khi, qlo), ss(klo, qhi, True) - 1
    ilo, ihi = ss(qhi, klo), ss(qlo, khi, True) - 1
    if tok_skip:
        jhi = torch.minimum(jhi, torch.arange(
            jhi.shape[0], dtype=torch.int32, device=jhi.device))
        ilo = torch.maximum(ilo, torch.arange(
            ilo.shape[0], dtype=torch.int32, device=ilo.device))
    return torch.stack([jlo, jhi]), torch.stack([ilo, ihi])


class VarlenLayout(NamedTuple):
    """What the kernels read besides the tensors: per-token segment ids
    and positions padded to whole blocks (q padding id n, k padding n + 1:
    they match nothing and keep the block ranges non-decreasing), each
    side's loop bounds (``block_bounds``) and the order in which the
    bfloat16 kernels walk each side's blocks (``longest_first``)."""
    segq: torch.Tensor
    posq: torch.Tensor
    segk: torch.Tensor
    posk: torch.Tensor
    q_bounds: torch.Tensor
    k_bounds: torch.Tensor
    q_order: torch.Tensor
    k_order: torch.Tensor


def _nblocks(t: int) -> int:
    return -(-t // BLOCK)


def longest_first(bounds: torch.Tensor) -> torch.Tensor:
    """The blocks of one side, longest run over the other side first (ties
    in block order), as int32 ``[n]``: launched in this order, the grid's
    last blocks are short ones."""
    return torch.argsort(bounds[1] - bounds[0], descending=True,
                         stable=True).to(torch.int32)


def varlen_layout(cu_q: torch.Tensor, cu_k: torch.Tensor, Tq: int, Tk: int,
                  tok_skip: bool) -> VarlenLayout:
    """The kernels' layout tables from cu_seqlens, on cu's device."""
    n = cu_q.shape[0] - 1
    nq, nk = _nblocks(Tq), _nblocks(Tk)
    segq, posq = segments(cu_q, Tq, nq * BLOCK, n)
    segk, posk = segments(cu_k, Tk, nk * BLOCK, n + 1)
    qb, kb = block_bounds(block_ranges(segq, nq, BLOCK),
                          block_ranges(segk, nk, BLOCK), tok_skip)
    return VarlenLayout(segq, posq, segk, posk, qb, kb, longest_first(qb),
                        longest_first(kb))


def same_cu_layout(cu_seqlens_q, cu_seqlens_k) -> bool:
    """Whether q and k share one packing, the precondition of the causal
    token-space skip: the same tensor, or equal shapes and values (a host
    compare). The same batch and token count do not imply one packing (q
    lens [1, 199] vs k lens [199, 1])."""
    if cu_seqlens_q is cu_seqlens_k:
        return True
    return (cu_seqlens_q.shape == cu_seqlens_k.shape
            and torch.equal(cu_seqlens_q.to(torch.int32),
                            cu_seqlens_k.to(torch.int32)))


def varlen_composite(q, k, v, cu_seqlens_q, cu_seqlens_k, scale=None,
                     causal: bool = False) -> torch.Tensor:
    """Dense ``[h, Tq, Tk]`` scores with segment-id masking, in plain
    torch (the reference's composite fallback); for small inputs only."""
    Tq, h, d = q.shape
    Tk, hk = k.shape[0], k.shape[1]
    if scale is None:
        scale = d ** -0.5
    segq, posq = segments(cu_seqlens_q, Tq, Tq, -1)
    segk, posk = segments(cu_seqlens_k, Tk, Tk, -2)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    live = segq[:, None] == segk[None, :]
    if causal:
        live &= posk[None, :] <= posq[:, None]
    logits = torch.where(live[None], logits, _NEG)
    probs = torch.where(live[None], torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("hqk,khd->qhd", probs, v.float()).to(q.dtype)


# -- plain version ------------------------------------------------------------

def _spans(cu: torch.Tensor, total: int, name: str) -> List[Tuple[int, int]]:
    """cu_seqlens as host (start, end) pairs, checked against the token
    count."""
    c = [int(x) for x in cu.tolist()]
    if not c or c[0] != 0 or c[-1] != total or \
            any(b < a for a, b in zip(c, c[1:])):
        raise ValueError(f"{name} {c} must rise from 0 to the token count "
                         f"{total}")
    return list(zip(c, c[1:]))


def _segment_pairs(cu_q, cu_k, Tq, Tk):
    """(q span, k span, causal mask or None) of every segment with tokens
    on both sides; the mask is top-left, ``pos_k <= pos_q``."""
    sq, sk = _spans(cu_q, Tq, "cu_seqlens_q"), _spans(cu_k, Tk, "cu_seqlens_k")
    if len(sq) != len(sk):
        raise ValueError(f"cu_seqlens_q has {len(sq)} segments, "
                         f"cu_seqlens_k {len(sk)}")
    return [(a, b) for a, b in zip(sq, sk) if a[1] > a[0] and b[1] > b[0]]


def _scores(qg, kk, scale, mask):
    """float32 scores of one group, ``[G, lq, lk]``, masked with -1e30."""
    s = torch.matmul(qg, kk.transpose(0, 1)) * scale
    return s if mask is None else torch.where(mask, s, _NEG)


def _causal_mask(lq, lk, causal, device):
    if not causal:
        return None
    return torch.ones((lq, lk), dtype=torch.bool, device=device).tril()


def flash_varlen_fwd_plain(q, k, v, cu_q, cu_k, causal: bool, scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: ``(out [Tq, h, d] in q's dtype, lse float32 [h,
    Tq])``, one float32 softmax per (segment, kv head) group."""
    Tq, H, _ = q.shape
    Tk, KV = k.shape[0], k.shape[1]
    G = H // KV
    out = torch.zeros_like(q)
    lse = torch.full((H, Tq), _NEG, dtype=torch.float32, device=q.device)
    for (q0, q1), (k0, k1) in _segment_pairs(cu_q, cu_k, Tq, Tk):
        mask = _causal_mask(q1 - q0, k1 - k0, causal, q.device)
        for h in range(KV):
            hs = slice(h * G, (h + 1) * G)
            qg = q[q0:q1, hs].float().transpose(0, 1)         # [G, lq, D]
            s = _scores(qg, k[k0:k1, h].float(), scale, mask)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            l = p.sum(dim=-1, keepdim=True)
            l = torch.where(l == 0, 1.0, l)
            o = torch.matmul(p, v[k0:k1, h].float()) / l
            out[q0:q1, hs] = o.transpose(0, 1).to(q.dtype)
            lse[hs, q0:q1] = (m + torch.log(l))[..., 0]
    return out, lse


def flash_varlen_bwd_plain(q, k, v, dout, lse, delta, cu_q, cu_k,
                           causal: bool, scale: float):
    """Plain backward from ``(lse, delta)``, both float32 ``[h, Tq]``: per
    (segment, kv head) group, ``p = exp(s - lse)`` (0 where masked) and
    ``ds = p * (dp - delta)``. Returns ``(dq, dk, dv)`` in the inputs'
    dtypes; tokens outside every live pair get zeros."""
    Tq, H, _ = q.shape
    Tk, KV = k.shape[0], k.shape[1]
    G = H // KV
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for (q0, q1), (k0, k1) in _segment_pairs(cu_q, cu_k, Tq, Tk):
        mask = _causal_mask(q1 - q0, k1 - k0, causal, q.device)
        for h in range(KV):
            hs = slice(h * G, (h + 1) * G)
            qg = q[q0:q1, hs].float().transpose(0, 1)          # [G, lq, D]
            dog = dout[q0:q1, hs].float().transpose(0, 1)
            kk, vv = k[k0:k1, h].float(), v[k0:k1, h].float()  # [lk, D]
            p = torch.exp(_scores(qg, kk, scale, mask)
                          - lse[hs, q0:q1][..., None])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            dp = torch.matmul(dog, vv.transpose(0, 1))         # [G, lq, lk]
            ds = p * (dp - delta[hs, q0:q1][..., None])
            dq[q0:q1, hs] = (torch.matmul(ds, kk) * scale).transpose(
                0, 1).to(q.dtype)
            dk[k0:k1, h] = (torch.einsum("gqk,gqd->kd", ds, qg)
                            * scale).to(k.dtype)
            dv[k0:k1, h] = torch.einsum("gqk,gqd->kd", p, dog).to(v.dtype)
    return dq, dk, dv


# -- kernels ------------------------------------------------------------------

def _bind(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ptt_varlen_fwd.argtypes = [P] * 7 + [I] * 5 + [F, I, I, P]
    lib.ptt_varlen_dq.argtypes = [P] * 9 + [I] * 5 + [F, I, I, P]
    lib.ptt_varlen_dkv.argtypes = [P] * 10 + [I] * 5 + [F, I, I, P]
    for fn in (lib.ptt_varlen_fwd, lib.ptt_varlen_dq, lib.ptt_varlen_dkv):
        fn.restype = ctypes.c_int


def _strides(*ts) -> ctypes.Array:
    """(token, head) element strides of each [T, heads, head_dim] tensor,
    as the host array the C launchers read."""
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _segs(lay: VarlenLayout, bounds: torch.Tensor, order: torch.Tensor
          ) -> ctypes.Array:
    return (ctypes.c_void_p * 6)(lay.segq.data_ptr(), lay.posq.data_ptr(),
                                 lay.segk.data_ptr(), lay.posk.data_ptr(),
                                 bounds.data_ptr(), order.data_ptr())


def _check(names, ts, like_q, like_k) -> None:
    """Every tensor on one CUDA device, [T, heads, head_dim] with head_dim
    contiguous and 16-byte aligned rows, in one supported dtype."""
    q = ts[0]
    for name, t in zip(names, ts):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [tokens, heads, head_dim], "
                             f"got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q's "
                             f"{q.dtype}")
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:2]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: head_dim must be contiguous and "
                             f"rows 16-byte aligned, strides {t.stride()}")
    Tq, H, D = q.shape
    k = ts[1]
    KV = k.shape[1]
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype}: the kernels take {DTYPES}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernels take {HEAD_DIMS}")
    if KV == 0 or H % KV or k.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         f"not form GQA heads")
    for name, t in zip(names, ts):
        want = like_q if name in ("q", "out", "dout", "dq") else like_k
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)}, want {want}")


def _check_layout(lay: VarlenLayout, q: torch.Tensor, Tq: int, Tk: int):
    nq, nk = _nblocks(Tq), _nblocks(Tk)
    want = {"segq": (nq * BLOCK,), "posq": (nq * BLOCK,),
            "segk": (nk * BLOCK,), "posk": (nk * BLOCK,),
            "q_bounds": (2, nq), "k_bounds": (2, nk), "q_order": (nq,),
            "k_order": (nk,)}
    for name, t in zip(lay._fields, lay):
        if t.dtype != torch.int32 or t.device != q.device \
                or tuple(t.shape) != want[name] or not t.is_contiguous():
            raise ValueError(f"layout {name} must be contiguous int32 "
                             f"{want[name]} on {q.device}")


def _check_bwd(q, k, v, dout, lse, delta, lay):
    Tq, H, D = q.shape
    Tk, KV = k.shape[0], k.shape[1]
    _check(("q", "k", "v", "dout"), (q, k, v, dout), (Tq, H, D),
           (Tk, KV, D))
    _check_layout(lay, q, Tq, Tk)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (H, Tq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{H}, {Tq}] on {q.device}")
    return H, KV, Tq, Tk, D


def _run(fn, args, ints, scale, causal, dtype, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, *ints, float(scale), int(causal),
                _build.DTYPE_CODES[str(dtype).removeprefix("torch.")], stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")


def flash_varlen_fwd(q, k, v, lay: VarlenLayout, causal: bool, scale: float):
    """The forward kernel; same result as :func:`flash_varlen_fwd_plain`
    over the cu_seqlens that ``lay`` was built from."""
    Tq, H, D = q.shape
    Tk, KV = k.shape[0], k.shape[1]
    _check(("q", "k", "v"), (q, k, v), (Tq, H, D), (Tk, KV, D))
    _check_layout(lay, q, Tq, Tk)
    out = torch.empty_like(q)
    lse = torch.empty((H, Tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or Tk == 0:
        return out.zero_(), lse.fill_(_NEG)
    lib = _build.load("flash_varlen", _bind)
    _run(lib.ptt_varlen_fwd,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          lse.data_ptr(), _segs(lay, lay.q_bounds, lay.q_order),
          _strides(q, k, v, out)),
         (H, KV, Tq, Tk, D), scale, causal, q.dtype, q.device)
    launches_fwd.add()
    return out, lse


def flash_varlen_dq(q, k, v, dout, lse, delta, lay: VarlenLayout,
                    causal: bool, scale: float):
    """The dq kernel: dq in q's dtype."""
    dims = _check_bwd(q, k, v, dout, lse, delta, lay)
    dq = torch.empty_like(q)
    if dq.numel() == 0 or dims[3] == 0:
        return dq.zero_()
    lib = _build.load("flash_varlen", _bind)
    _run(lib.ptt_varlen_dq,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          _segs(lay, lay.q_bounds, lay.q_order),
          _strides(q, k, v, dout, dq)),
         dims, scale, causal, q.dtype, q.device)
    launches_dq.add()
    return dq


def flash_varlen_dkv(q, k, v, dout, lse, delta, lay: VarlenLayout,
                     causal: bool, scale: float):
    """The dk/dv kernel: (dk, dv) in k's and v's dtype."""
    dims = _check_bwd(q, k, v, dout, lse, delta, lay)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0 or dims[2] == 0:
        return dk.zero_(), dv.zero_()
    lib = _build.load("flash_varlen", _bind)
    _run(lib.ptt_varlen_dkv,
         (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
          lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          _segs(lay, lay.k_bounds, lay.k_order),
          _strides(q, k, v, dout, dk, dv)),
         dims, scale, causal, q.dtype, q.device)
    launches_dkv.add()
    return dk, dv


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA tensor
    (the kernels); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"flash_varlen: no kernel for {t.device}")
    return True


def _check_cu(cu: torch.Tensor, q: torch.Tensor, name: str) -> None:
    if cu.dtype != torch.int32 or cu.device != q.device or cu.dim() != 1:
        raise ValueError(f"{name} must be int32 [batch + 1] on {q.device}, "
                         f"got {cu.dtype} {tuple(cu.shape)} on {cu.device}")


# -- autograd -----------------------------------------------------------------

class _Varlen(torch.autograd.Function):
    """out over the packed layout; saves (q, k, v, out, lse) and, on the
    card, the kernels' layout tables for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal, scale, tok_skip):
        if _on_card(q):
            for name, cu in (("cu_seqlens_q", cu_q), ("cu_seqlens_k", cu_k)):
                _check_cu(cu, q, name)
            if cu_q.shape != cu_k.shape:
                raise ValueError("cu_seqlens_q and cu_seqlens_k must have "
                                 "one batch size")
            lay = varlen_layout(cu_q, cu_k, q.shape[0], k.shape[0], tok_skip)
            out, lse = flash_varlen_fwd(q, k, v, lay, causal, scale)
        else:
            lay = None
            out, lse = flash_varlen_fwd_plain(q, k, v, cu_q, cu_k, causal,
                                              scale)
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k)
        ctx.lay, ctx.causal, ctx.scale = lay, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        # delta = rowsum(dout * out), float32 [h, Tq]
        delta = (dout.float() * out.float()).sum(-1).transpose(0, 1) \
            .contiguous()
        lay, causal, scale = ctx.lay, ctx.causal, ctx.scale
        if lay is None:
            dq, dk, dv = flash_varlen_bwd_plain(q, k, v, dout, lse, delta,
                                                cu_q, cu_k, causal, scale)
        else:
            dq = flash_varlen_dq(q, k, v, dout, lse, delta, lay, causal,
                                 scale)
            dk, dv = flash_varlen_dkv(q, k, v, dout, lse, delta, lay, causal,
                                      scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        causal: bool = False) -> torch.Tensor:
    """Packed varlen attention: q ``[total_q, heads, head_dim]``, k/v
    ``[total_k, kv_heads, head_dim]``, ``cu_seqlens_*`` ``[batch+1]``
    prefix sums (cast to int32); ``max_seqlen_*`` are accepted for API
    parity and unused; scale defaults to ``head_dim ** -0.5``. Returns
    ``[total_q, heads, head_dim]`` in q's dtype. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tok_skip = bool(causal) and same_cu_layout(cu_seqlens_q, cu_seqlens_k)
    return _Varlen.apply(q, k, v, cu_seqlens_q.to(torch.int32),
                         cu_seqlens_k.to(torch.int32), bool(causal),
                         float(scale), tok_skip)
