"""The round-2 op tranche: math, norms, losses and indexing.

Counterparts of the entries of ``paddle_tpu/ops/kernels/extra_math.py``
at ``ops.yaml:496-543`` that ``math_ext.py`` does not already hold: the
scaled activations, ``logspace``, ``complex``, the norms, ``add_n`` /
``mean_all``, the losses, ``accuracy``, the shape utilities, the
data-dependent indexing ops, ``edit_distance``, ``view_dtype``,
``set_value`` and ``einsum``. Each is the reference's arithmetic in torch
ops, with its conventions:

- ``frobenius_norm``, ``squared_l2_norm`` and ``clip_by_norm`` sum in
  float32 and return the input's dtype;
- ``kldiv_loss`` is 0 where ``label <= 0``; ``bce_loss`` clips its input
  at 1e-12; ``p_norm`` clamps its sum at ``epsilon`` before the root;
- ``view_dtype`` is ``lax.bitcast_convert_type``: a narrower dtype adds a
  trailing dim of the width ratio, a wider one removes it;
- ``unique_consecutive``, ``repeat_interleave_with_tensor_index`` and
  ``edit_distance`` have data-dependent output shapes (``jit: false`` in
  the reference) and raise while a step is captured; ``edit_distance``
  runs its dynamic program on the host, as the reference does, and
  returns on the input's device;
- index outputs are int64 (the ``dtype`` argument's default), where the
  reference returns int32.

``fill_`` writes its input in place (``ops.dispatcher.inplace_apply``)
and returns it, as the reference's ``call_op("fill_")`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.device import dtype_of, layer_device
from ..dispatcher import get_op, inplace_apply, register_kernel
from .creation import _scalar, set_at
from .manipulation import _not_captured
from .math_ext import _list


# -- activations and creation ---------------------------------------------------

@register_kernel("stanh")
def _stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_kernel("tanh_shrink")
def _tanh_shrink(x):
    return x - torch.tanh(x)


@register_kernel("logspace")
def _logspace(start, stop, num, base=10.0, dtype=None):
    exps = torch.linspace(float(_scalar(start)), float(_scalar(stop)),
                          int(_scalar(num)), dtype=torch.float32,
                          device=layer_device())
    out = torch.pow(float(_scalar(base)), exps)
    return out if dtype is None else out.to(dtype_of(dtype))


@register_kernel("complex")
def _complex(real, imag):
    return torch.complex(real, imag)


# -- norms -----------------------------------------------------------------------

@register_kernel("dist")
def _dist(x, y, p=2.0):
    d = (x - y).reshape(-1)
    p = float(p)
    if p == float("inf"):
        return d.abs().max()
    if p == 0:
        return (d != 0).sum().to(x.dtype)
    return (d.abs() ** p).sum() ** (1.0 / p)


@register_kernel("p_norm")
def _p_norm(x, porder=2.0, axis=-1, epsilon=1e-12, keepdim=False,
            asvector=False):
    if asvector:
        x, axis = x.reshape(-1), 0
    p, axis = float(porder), int(axis)
    if p == float("inf"):
        return x.abs().amax(dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return x.abs().amin(dim=axis, keepdim=keepdim)
    if p == 0:
        return (x != 0).sum(dim=axis, keepdim=keepdim).to(x.dtype)
    s = (x.abs() ** p).sum(dim=axis, keepdim=keepdim)
    return s.clamp(min=epsilon) ** (1.0 / p)


def _dims(axis):
    if axis is None:
        return None
    return [int(axis)] if isinstance(axis, int) else [int(a) for a in axis]


@register_kernel("frobenius_norm")
def _frobenius_norm(x, axis=None, keepdim=False):
    sq = x.float() ** 2
    s = sq.sum() if axis is None and not keepdim else \
        sq.sum(dim=_dims(axis), keepdim=keepdim)
    return s.sqrt().to(x.dtype)


@register_kernel("squared_l2_norm")
def _squared_l2_norm(x):
    return (x.float() ** 2).sum().to(x.dtype)


@register_kernel("clip_by_norm")
def _clip_by_norm(x, max_norm=1.0):
    norm = (x.float() ** 2).sum().sqrt()
    scale = torch.clamp(float(max_norm) / norm.clamp(min=1e-12), max=1.0)
    return x * scale.to(x.dtype)


@register_kernel("add_n")
def _add_n(inputs):
    inputs = _list(inputs)
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


@register_kernel("mean_all")
def _mean_all(x):
    return x.mean()


# -- losses ------------------------------------------------------------------------

@register_kernel("label_smooth")
def _label_smooth(label, prior_dist=None, epsilon=0.1):
    c = label.shape[-1]
    prior = prior_dist if prior_dist is not None else \
        torch.full((c,), 1.0 / c, dtype=label.dtype, device=label.device)
    return (1.0 - epsilon) * label + epsilon * prior


@register_kernel("huber_loss")
def _huber_loss(input, label, delta=1.0):
    r = input - label
    a = r.abs()
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


@register_kernel("bce_loss")
def _bce_loss(input, label):
    x = input.clamp(1e-12, 1.0 - 1e-12)
    return -(label * torch.log(x) + (1.0 - label) * torch.log(1.0 - x))


@register_kernel("kldiv_loss")
def _kldiv_loss(x, label, reduction="mean", log_target=False):
    if log_target:
        out = torch.exp(label) * (label - x)
    else:
        out = torch.where(label > 0, label * (torch.log(label) - x),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    if reduction == "mean":
        return out.mean()
    if reduction == "batchmean":
        return out.sum() / x.shape[0]
    if reduction == "sum":
        return out.sum()
    return out


@register_kernel("log_loss")
def _log_loss(input, label, epsilon=1e-4):
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


@register_kernel("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(x, label, pos_weight=None, normalize=False,
                ignore_index=-100):
    loss = x.clamp(min=0) - x * label + torch.log1p(torch.exp(-x.abs()))
    if pos_weight is not None:
        loss = loss * ((pos_weight - 1.0) * label + 1.0)
    mask = label != ignore_index
    loss = torch.where(mask, loss, torch.zeros((), dtype=loss.dtype,
                                               device=loss.device))
    if normalize:
        loss = loss / mask.sum().to(loss.dtype).clamp(min=1.0)
    return loss


@register_kernel("accuracy")
def _accuracy(x, label, k=1):
    """``[N, C]`` scores against ``[N]`` / ``[N, 1]`` labels: the top-k
    accuracy, a float32 scalar."""
    lbl = label.reshape(label.shape[0], -1)[:, 0]
    top = torch.topk(x, int(k), dim=-1).indices
    return (top == lbl[:, None]).any(dim=1).float().mean()


# -- shape utilities and indexing --------------------------------------------------

@register_kernel("is_empty")
def _is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


@register_kernel("fill_")
def _fill_(x, value=0.0):
    return inplace_apply(x, get_op("fill"), (value,))


@register_kernel("assign_value")
def _assign_value(shape=(), dtype="float32", values=()):
    arr = np.asarray(values).reshape([int(s) for s in shape])
    return torch.as_tensor(arr, dtype=dtype_of(dtype), device=layer_device())


@register_kernel("unique_consecutive")
def _unique_consecutive(x, return_inverse=False, return_counts=False,
                        axis=None, dtype="int64"):
    _not_captured("unique_consecutive")
    out, inv, cnt = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True,
        dim=None if axis is None else int(axis))
    res = [out]
    idt = dtype_of(dtype)
    if return_inverse:
        res.append((inv.reshape(-1) if axis is None else inv).to(idt))
    if return_counts:
        res.append(cnt.to(idt))
    return res[0] if len(res) == 1 else tuple(res)


@register_kernel("repeat_interleave_with_tensor_index")
def _repeat_interleave_tensor(x, repeats, axis=0):
    _not_captured("repeat_interleave_with_tensor_index")
    return torch.repeat_interleave(x, repeats.to(x.device).long(),
                                   dim=int(axis))


@register_kernel("shard_index")
def _shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    size = (int(index_num) + int(nshards) - 1) // int(nshards)
    lo = int(shard_id) * size
    inside = (input >= lo) & (input < lo + size)
    return torch.where(inside, input - lo,
                       torch.full_like(input, int(ignore_value)))


def _levenshtein(h, r) -> int:
    """The edit distance of two id sequences (one DP row at a time)."""
    dp = np.arange(len(r) + 1, dtype=np.int64)
    for i in range(1, len(h) + 1):
        prev = dp.copy()
        dp[0] = i
        for j in range(1, len(r) + 1):
            cost = 0 if h[i - 1] == r[j - 1] else 1
            dp[j] = min(dp[j - 1] + 1, prev[j] + 1, prev[j - 1] + cost)
    return int(dp[len(r)])


@register_kernel("edit_distance")
def _edit_distance(hyps, refs, hypslength=None, refslength=None,
                   normalized=True):
    """Batched Levenshtein distance on the host: ``([B, 1] float32,
    [1] int64 batch size)`` on the input's device."""
    _not_captured("edit_distance")
    h, r = hyps.cpu().numpy(), refs.cpu().numpy()
    b = h.shape[0]
    hl = hypslength.cpu().numpy().reshape(-1) if hypslength is not None \
        else np.full(b, h.shape[1])
    rl = refslength.cpu().numpy().reshape(-1) if refslength is not None \
        else np.full(b, r.shape[1])
    out = np.zeros((b, 1), np.float32)
    for i in range(b):
        n = int(rl[i])
        d = float(_levenshtein(h[i, :int(hl[i])], r[i, :n]))
        out[i, 0] = d / max(n, 1) if normalized else d
    return (torch.from_numpy(out).to(hyps.device),
            torch.tensor([b], dtype=torch.int64, device=hyps.device))


@register_kernel("view_dtype")
def _view_dtype(x, dtype):
    dt = dtype_of(dtype)
    old, new = x.element_size(), torch.empty((), dtype=dt).element_size()
    if new == old:
        return x.view(dt)
    if new < old:
        return x.contiguous().view(dt).reshape(x.shape + (old // new,))
    if x.shape[-1] != new // old:
        raise ValueError(f"view_dtype: the last dim {x.shape[-1]} must be "
                         f"{new // old} to widen {x.dtype} to {dt}")
    return x.contiguous().view(dt).squeeze(-1)


@register_kernel("set_value")
def _set_value(x, value=None, starts=(), ends=(), steps=(), axes=(),
               shape=()):
    """``x`` with ``x[slices] = value`` (a new tensor: grads reach ``x``
    outside the slices and ``value``)."""
    idx = [slice(None)] * x.dim()
    for a, s, e, st in zip(axes, starts, ends, steps):
        idx[int(a)] = slice(int(s), int(e), int(st))
    val = torch.zeros((), dtype=x.dtype, device=x.device) if value is None \
        else torch.as_tensor(value, device=x.device).to(x.dtype)
    return set_at(x, tuple(idx), val)


@register_kernel("einsum")
def _einsum(operands, equation=""):
    return torch.einsum(equation, *_list(operands))
