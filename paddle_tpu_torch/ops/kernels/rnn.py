"""Recurrences and the sequence losses: ``lstm_layer``, ``gru_layer``,
``simple_rnn_layer``, ``ctc_loss`` and ``rnnt_loss``.

Counterparts of ``paddle_tpu/ops/kernels/rnn.py:24-173`` and
``graph.py:221-310`` (``rnnt_loss``). The reference scans over time with
``lax.scan``; here each op is a Python loop over time in torch ops, and
its gradients come from autograd through the loop, as the reference's
come from ``jax.vjp`` through the scan. The gate order is [i, f, g, o]
for the LSTM and [r, z, n] for the GRU. The input projection ``x @
w_ih.T`` is one product over every step before the loop (the reference
adds it per step: a tolerance apart, not bits). These ops are not routed
to cuDNN: ``lens`` freezes the carry and zeros the outputs past each
sequence's length, and ``reverse`` runs each sequence backwards within
its own valid range, which cuDNN's packed sequences would have to be
proven to reproduce. Under step capture the loop's launches become one
graph replay.

``ctc_loss`` is the reference's log-space alpha recursion over the
blank-extended labels; ``rnnt_loss`` runs the transducer lattice over T,
each step's emit recursion over U in closed form through
``logcumsumexp`` (the reference's TPU choice is an associative scan; the
recurrence is the same), and ``fastemit_lambda`` scales the emit arcs'
gradients by ``1 + lambda``, leaving the loss value as it is.
"""

from __future__ import annotations

import torch

from ..dispatcher import hooked, register_kernel

NEG_INF = -1e30


def _seq_prepare(x, lens, reverse):
    """``(x to scan, live [T, B] bool or None, restore(out))``: with
    ``lens``, ``reverse`` maps step t of each sequence to ``lens - 1 - t``
    within its valid range, and ``restore`` zeros the outputs past it."""
    T, B = x.shape[0], x.shape[1]
    if lens is None:
        if not reverse:
            return x, None, lambda out: out
        return x.flip(0), None, lambda out: out.flip(0)
    lens = lens.to(device=x.device, dtype=torch.long)
    ts = torch.arange(T, device=x.device)[:, None]
    live = ts < lens[None, :]
    if not reverse:
        return x, live, lambda out: out * live[..., None].to(out.dtype)
    idx = torch.where(live, lens[None, :] - 1 - ts, ts)
    cols = torch.arange(B, device=x.device)[None, :]

    def restore(out):
        return out[idx, cols] * live[..., None].to(out.dtype)

    return x[idx, cols], live, restore


def _keep(live, t, new, old):
    return new if live is None else torch.where(live[t][:, None], new, old)


@register_kernel("lstm_layer")
def _lstm_layer(x, w_ih, w_hh, b_ih, b_hh, h0, c0, lens=None,
                reverse=False):
    """x ``[T, B, I]``, w_ih ``[4H, I]``, w_hh ``[4H, H]``, biases
    ``[4H]``, h0 / c0 ``[B, H]`` -> ``(out [T, B, H], hT, cT)``."""
    xs, live, restore = _seq_prepare(x, lens, reverse)
    xw = torch.matmul(xs, w_ih.t()) + (b_ih + b_hh)
    w_hh_t = w_hh.t()
    H = w_hh.shape[1]
    h, c, outs = h0, c0, []
    for t in range(xs.shape[0]):
        gates = torch.addmm(xw[t], h, w_hh_t)
        sig = torch.sigmoid(gates)
        i, f, o = sig[:, :H], sig[:, H:2 * H], sig[:, 3 * H:]
        g = torch.tanh(gates[:, 2 * H:3 * H])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        h, c = _keep(live, t, h_new, h), _keep(live, t, c_new, c)
        outs.append(h)
    return restore(torch.stack(outs)), h, c


@register_kernel("gru_layer")
def _gru_layer(x, w_ih, w_hh, b_ih, b_hh, h0, lens=None, reverse=False):
    """x ``[T, B, I]``, w_ih ``[3H, I]``, w_hh ``[3H, H]``, biases
    ``[3H]``, h0 ``[B, H]`` -> ``(out [T, B, H], hT)``."""
    xs, live, restore = _seq_prepare(x, lens, reverse)
    gi_all = torch.matmul(xs, w_ih.t()) + b_ih
    w_hh_t = w_hh.t()
    H = w_hh.shape[1]
    h, outs = h0, []
    for t in range(xs.shape[0]):
        gi = gi_all[t]
        gh = torch.addmm(b_hh, h, w_hh_t)
        rz = torch.sigmoid(gi[:, :2 * H] + gh[:, :2 * H])
        r, z = rz[:, :H], rz[:, H:]
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        h = _keep(live, t, (1 - z) * n + z * h, h)
        outs.append(h)
    return restore(torch.stack(outs)), h


@register_kernel("simple_rnn_layer")
def _simple_rnn_layer(x, w_ih, w_hh, b_ih, b_hh, h0, lens=None,
                      reverse=False, activation="tanh"):
    act = torch.tanh if activation == "tanh" else torch.relu
    xs, live, restore = _seq_prepare(x, lens, reverse)
    xw = torch.matmul(xs, w_ih.t()) + (b_ih + b_hh)
    w_hh_t = w_hh.t()
    h, outs = h0, []
    for t in range(xs.shape[0]):
        h = _keep(live, t, act(torch.addmm(xw[t], h, w_hh_t)), h)
        outs.append(h)
    return restore(torch.stack(outs)), h


@register_kernel("ctc_loss")
def _ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
              norm_by_times=False):
    """CTC negative log-likelihood per batch element.

    log_probs ``[T, B, C]`` (log-softmaxed), labels ``[B, L]`` padded,
    lengths ``[B]``. Alpha over the extended sequence (S = 2L + 1:
    blank, l1, blank, ..., blank) at -1e30 for "impossible"; a label may
    skip the blank before it unless it repeats the one before; past its
    input length a sequence's alpha is frozen; the likelihood ends at the
    final blank or the final label (only the blank for an empty label)."""
    T, B, _ = log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = log_probs.device
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    same = torch.cat([torch.ones((B, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & ~same
    in_len = input_lengths.to(device=dev, dtype=torch.long)
    lab_len = label_lengths.to(device=dev, dtype=torch.long)
    # each step's log-probs at the extended labels, as a product with
    # their one-hot rows (exact: a gather's backward would add the blank's
    # many grads with atomics, in no fixed order)
    onehot = torch.nn.functional.one_hot(ext, log_probs.shape[2]).to(
        log_probs.dtype)
    emit = torch.bmm(log_probs.transpose(0, 1), onehot.transpose(1, 2)) \
        .transpose(0, 1)                                        # [T, B, S]
    neg = torch.full((B, 2), NEG_INF, dtype=log_probs.dtype, device=dev)
    alpha = torch.cat([emit[0, :, :1],
                       torch.where(lab_len[:, None] > 0, emit[0, :, 1:2],
                                   neg[:, :1]),
                       neg[:, :1].expand(B, S - 2)], dim=1)
    live = torch.arange(1, T, device=dev)[:, None] < in_len[None, :]
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip, torch.cat([neg, alpha[:, :-2]], dim=1),
                            NEG_INF)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        alpha = torch.where(live[t - 1][:, None], merged + emit[t], alpha)
    end = 2 * lab_len
    a_end = alpha.gather(1, end[:, None])[:, 0]
    a_end1 = alpha.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    loss = -torch.logaddexp(a_end, torch.where(lab_len > 0, a_end1, NEG_INF))
    if norm_by_times:
        loss = loss / in_len.clamp(min=1).to(loss.dtype)
    return loss


class _ScaleGrad(torch.autograd.Function):
    """The identity forward; the grad times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


@register_kernel("rnnt_loss")
def _rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
               fastemit_lambda=0.0):
    """Transducer NLL over the ``[B, T, U, V]`` lattice (``input``: logits,
    log-softmaxed here in float32; ``label`` ``[B, U - 1]``).

    Alpha at t = 0 sums the emit arcs from (0, 0); each later step takes
    the blank arc from t - 1 and then the emit recursion ``a[u] =
    logaddexp(b[u], a[u - 1] + e[u - 1])``, written as ``C + logcumsumexp(b
    - C)`` with C the running sum of e; positions past a label length are
    at -1e30 and a sequence's alpha is frozen past its input length. The
    loss is ``-(alpha[T_b - 1, U_b] + blank[T_b - 1, U_b])``."""
    lp = torch.log_softmax(input.float(), dim=-1)
    B, T, U, _ = lp.shape
    dev = lp.device
    lab = label.to(device=dev, dtype=torch.long)
    tl = input_lengths.to(device=dev, dtype=torch.long)
    ul = label_lengths.to(device=dev, dtype=torch.long)
    blank_lp = lp[..., blank]                                  # [B, T, U]
    lab_pad = torch.cat([lab, lab.new_zeros((B, 1))], dim=1)[:, :U]
    emit_lp = lp.gather(3, lab_pad[:, None, :, None].expand(B, T, U, 1))[
        ..., 0]
    if fastemit_lambda:
        emit_lp = _ScaleGrad.apply(emit_lp, 1.0 + float(fastemit_lambda))
    in_range = torch.arange(U, device=dev)[None, :] <= ul[:, None]
    zero = lp.new_zeros((B, 1))

    def masked(a):
        return torch.where(in_range, a, NEG_INF)

    alpha = masked(torch.cat([zero, torch.cumsum(emit_lp[:, 0, :-1], 1)], 1))
    for t in range(1, T):
        from_blank = alpha + blank_lp[:, t - 1]
        run = torch.cat([zero, torch.cumsum(emit_lp[:, t, :-1], 1)], 1)
        new = masked(run + torch.logcumsumexp(from_blank - run, dim=1))
        alpha = torch.where((t < tl)[:, None], new, alpha)
    rows = torch.arange(B, device=dev)
    a_term = alpha.gather(1, ul[:, None])[:, 0]
    bl_term = blank_lp[rows, (tl - 1).clamp(min=0), ul]
    return (-(a_term + bl_term)).to(input.dtype)


lstm_layer = hooked("lstm_layer", _lstm_layer)
gru_layer = hooked("gru_layer", _gru_layer)
simple_rnn_layer = hooked("simple_rnn_layer", _simple_rnn_layer)
ctc_loss = hooked("ctc_loss", _ctc_loss)
rnnt_loss = hooked("rnnt_loss", _rnnt_loss)
