"""``paddle.nn.functional`` over the ported ops.

Counterpart of ``paddle_tpu/nn/functional/__init__.py:1-148``, cut to the
ops the port's layers reach: each name is the registry op
(``ops.dispatcher.get_op``), plus the reference's wrappers ``embedding``,
``cross_entropy``, ``interpolate`` and ``flash_attention``. The rest of the
reference's functional surface (``celu``, ``hardtanh``, ``glu``,
``gumbel_softmax``, ``unfold``, ``cosine_similarity``, ``normalize``,
``sequence_mask``, the CTC and RNN-T losses) is ROADMAP A4.
"""

from __future__ import annotations

import torch

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
mse_loss = _get_op("mse_loss")
l1_loss = _get_op("l1_loss")
smooth_l1_loss = _get_op("smooth_l1_loss")
nll_loss = _get_op("nll_loss")
kl_div = _get_op("kl_div")
binary_cross_entropy = _get_op("binary_cross_entropy")
binary_cross_entropy_with_logits = _get_op(
    "binary_cross_entropy_with_logits")
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
