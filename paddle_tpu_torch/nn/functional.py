"""``paddle.nn.functional`` over the ported ops.

Counterpart of ``paddle_tpu/nn/functional/__init__.py:1-148``: each name
is the registry op (``ops.dispatcher.get_op``), plus the reference's
wrappers ``embedding``, ``cross_entropy``, ``interpolate``,
``flash_attention``, ``normalize``, ``sequence_mask``, ``ctc_loss`` and
``rnnt_loss``.
"""

from __future__ import annotations

import torch

from ..core.device import dtype_of as _dtype_of
from ..ops.dispatcher import call_op as _call_op
from ..ops.dispatcher import get_op as _get_op

relu = _get_op("relu")
relu6 = _get_op("relu6")
gelu = _get_op("gelu")
silu = _get_op("silu")
swish = _get_op("swish")
mish = _get_op("mish")
sigmoid = _get_op("sigmoid")
tanh = _get_op("tanh")
softmax = _get_op("softmax")
log_softmax = _get_op("log_softmax")
softplus = _get_op("softplus")
softsign = _get_op("softsign")
leaky_relu = _get_op("leaky_relu")
prelu = _get_op("prelu")
elu = _get_op("elu")
selu = _get_op("selu")
celu = _get_op("celu")
hardtanh = _get_op("hardtanh")
glu = _get_op("glu")
gumbel_softmax = _get_op("gumbel_softmax")
hardswish = _get_op("hardswish")
hardsigmoid = _get_op("hardsigmoid")
swiglu = _get_op("swiglu")
linear = _get_op("linear")
embedding_op = _get_op("embedding")
layer_norm = _get_op("layer_norm")
rms_norm = _get_op("rms_norm")
group_norm = _get_op("group_norm")
instance_norm = _get_op("instance_norm")
dropout = _get_op("dropout")
conv2d = _get_op("conv2d")
conv1d = _get_op("conv1d")
conv2d_transpose = _get_op("conv2d_transpose")
max_pool2d = _get_op("max_pool2d")
avg_pool2d = _get_op("avg_pool2d")
adaptive_avg_pool2d = _get_op("adaptive_avg_pool2d")
adaptive_max_pool2d = _get_op("adaptive_max_pool2d")
pad = _get_op("pad")
one_hot = _get_op("one_hot")
pixel_shuffle = _get_op("pixel_shuffle")
unfold = _get_op("unfold")
mse_loss = _get_op("mse_loss")
l1_loss = _get_op("l1_loss")
smooth_l1_loss = _get_op("smooth_l1_loss")
nll_loss = _get_op("nll_loss")
kl_div = _get_op("kl_div")
binary_cross_entropy = _get_op("binary_cross_entropy")
binary_cross_entropy_with_logits = _get_op(
    "binary_cross_entropy_with_logits")
softmax_with_cross_entropy = _get_op("softmax_with_cross_entropy")
cosine_similarity = _get_op("cosine_similarity")
scaled_dot_product_attention = _get_op("scaled_dot_product_attention")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    return embedding_op(x, weight, padding_idx=padding_idx)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross entropy (``use_softmax=False``: ``input`` holds
    probabilities, and this is ``nll_loss(log(input))``)."""
    if not use_softmax:
        return nll_loss(torch.log(input), label, weight=weight,
                        ignore_index=ignore_index, reduction=reduction)
    return _call_op("cross_entropy_mean", input, label,
                    soft_label=soft_label, ignore_index=ignore_index,
                    axis=axis, weight=weight, reduction=reduction)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, name=None):
    """``[batch, seq, heads, head_dim]`` attention through the flash
    routing (the flash kernels on the card)."""
    out = _call_op("flash_attention", query, key, value, is_causal=causal,
                   dropout_p=dropout)
    return (out, None) if return_softmax else out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW", name=None):
    h, w = (x.shape[2], x.shape[3]) if data_format == "NCHW" \
        else (x.shape[1], x.shape[2])
    if size is not None:
        oh, ow = int(size[0]), int(size[1])
    else:
        sf = scale_factor
        sf = (sf, sf) if isinstance(sf, (int, float)) else sf
        oh, ow = int(h * sf[0]), int(w * sf[1])
    if mode == "nearest":
        return _call_op("interpolate_nearest", x, out_h=oh, out_w=ow,
                        data_format=data_format)
    return _call_op("interpolate_bilinear", x, out_h=oh, out_w=ow,
                    align_corners=align_corners, data_format=data_format)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(norm_p(x, axis), epsilon)``."""
    n = _call_op("norm", x, p=float(p), axis=axis, keepdim=True)
    return x / _call_op("clip", n, min=epsilon)


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """``[..., maxlen]``: 1 where the position is below the length."""
    maxlen = maxlen or int(lengths.max().item())
    row = torch.arange(maxlen, device=lengths.device)
    return (row[None, :] < lengths[..., None]).to(_dtype_of(dtype))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``[T, B, C]`` logits (log-softmaxed here), labels ``[B,
    L]`` padded; ``mean`` divides each loss by its label length, then
    averages (Paddle's reduction)."""
    lp = _call_op("log_softmax", log_probs, axis=-1)
    loss = _call_op("ctc_loss", lp, labels, input_lengths, label_lengths,
                    blank=blank, norm_by_times=norm_by_times)
    if reduction == "mean":
        return _call_op("mean", loss / label_lengths.to(loss.dtype))
    if reduction == "sum":
        return _call_op("sum", loss)
    return loss


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """The transducer loss over ``[B, T, U, V]`` logits, label ``[B, U -
    1]``; ``fastemit_lambda`` scales the emit arcs' gradients."""
    loss = _call_op("rnnt_loss", input, label, input_lengths, label_lengths,
                    blank=blank, fastemit_lambda=fastemit_lambda)
    if reduction == "mean":
        return _call_op("mean", loss)
    if reduction == "sum":
        return _call_op("sum", loss)
    return loss
