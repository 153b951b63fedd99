"""The round-3 compat tranche of the op table (``ops.yaml:689-715``).

Counterparts of ``paddle_tpu/ops/kernels/compat_tranche.py:37-385``, each
a plain torch composite of the same arithmetic: ``lrn``, ``multiplex``,
``fill_diagonal_tensor``, ``grad_add``, ``fc``, ``identity_loss``,
``shuffle_channel``, ``soft_relu``, ``partial_sum``, ``bilinear``,
``sequence_mask_op``, ``number_count``, ``seed_op``,
``full_batch_size_like``, ``row_conv``, ``fused_elemwise_add_activation``,
``margin_cross_entropy``, ``hsigmoid_loss``, ``graph_khop_sampler``,
``lars_momentum_op``, ``share_data`` and ``depthwise_conv2d_transpose``
(``shuffle_batch`` and ``uniform_random_batch_size_like`` live in
``random.py``). Where the reference's conventions need care:

- ``margin_cross_entropy`` clips the target cosine to ±(1 − 1e-6) before
  ``arccos``, whose gradient is infinite at ±1;
- ``hsigmoid_loss``'s default heap coding reads ``w`` at node -1 (the last
  row, as JAX's indexing wraps) for the levels above a short code; those
  terms are masked out of the loss but not out of the pre-sigmoid output;
- ``number_count`` drops ids outside ``[0, upper_range)``;
- ``seed_op`` with ``seed`` 0 returns the port's seed
  (``paddle_tpu_torch.seed``), as the reference reads its generator's;
- ``sequence_mask_op`` without ``max_len`` and ``graph_khop_sampler``
  read values on the host (``jit: false`` in the reference) and raise
  while a step is being captured;
- ``lars_momentum_op`` falls back to the plain learning rate when either
  norm is 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.device import dtype_of, layer_device
from ...core.generator import default_generator
from ..dispatcher import register_kernel
from .graph import graph_sample_neighbors
from .manipulation import _not_captured
from .nn import _conv2d_transpose


@register_kernel("lrn")
def lrn(x, n=5, k=1.0, alpha=1e-4, beta=0.75, data_format="NCHW"):
    """Cross-channel local response normalisation over a window of ``n``
    channels starting at ``c - (n - 1) // 2``, in float32."""
    if data_format != "NCHW":
        x = torch.movedim(x, -1, 1)
    xf = x.float()
    half = (n - 1) // 2
    sq = F.pad(xf * xf, (0, 0, 0, 0, half, n - 1 - half))
    c = x.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, n):
        acc = acc + sq[:, i:i + c]
    out = (xf / (k + alpha * acc) ** beta).to(x.dtype)
    if data_format != "NCHW":
        out = torch.movedim(out, 1, -1)
    return out


@register_kernel("multiplex")
def multiplex(inputs, index):
    """``out[i] = inputs[index[i]][i]``."""
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


@register_kernel("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1):
    """``y`` written along the ``(dim1, dim2)`` diagonal (``offset`` as in
    torch)."""
    d1, d2 = dim1 % x.dim(), dim2 % x.dim()
    perm = [d for d in range(x.dim()) if d not in (d1, d2)] + [d1, d2]
    xt = x.permute(perm).clone()
    n1, n2 = xt.shape[-2], xt.shape[-1]
    n = max(min(n1, n2 - offset) if offset >= 0 else min(n1 + offset, n2),
            0)
    di = torch.arange(n, device=x.device)
    r = di + (-offset if offset < 0 else 0)
    c = di + (offset if offset > 0 else 0)
    xt[..., r, c] = y.to(x.dtype)
    return xt.permute(np.argsort(perm).tolist())


@register_kernel("grad_add")
def grad_add(x, y):
    return x + y


@register_kernel("fc")
def fc(input, w, bias=None, in_num_col_dims=1, activation_type=""):
    """The leading ``in_num_col_dims`` axes kept, the rest flattened and
    multiplied by ``w`` ``[k, n]``, the bias added, then ``relu`` where
    ``activation_type`` asks."""
    lead = input.shape[:in_num_col_dims]
    x2 = input.reshape(int(np.prod(lead)), -1)
    out = torch.matmul(x2.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    out = out.to(input.dtype).reshape(*lead, w.shape[1])
    if activation_type == "relu":
        out = torch.relu(out)
    return out


@register_kernel("identity_loss")
def identity_loss(x, reduction=1):
    if reduction in (0, "sum"):
        return x.sum()
    if reduction in (1, "mean"):
        return x.mean()
    return x


@register_kernel("shuffle_channel")
def shuffle_channel(x, group=1):
    n, c, h, w = x.shape
    return (x.reshape(n, group, c // group, h, w).transpose(1, 2)
            .reshape(n, c, h, w))


@register_kernel("soft_relu")
def soft_relu(x, threshold=40.0):
    return torch.log1p(torch.exp(x.clamp(-threshold, threshold)))


@register_kernel("partial_sum")
def partial_sum(xs, start_index=0, length=-1):
    """The sum of each input's columns ``[start, start + length)``."""
    end = None if length < 0 else start_index + length
    out = None
    for x in xs:
        piece = x[:, start_index:end]
        out = piece if out is None else out + piece
    return out


@register_kernel("bilinear")
def bilinear(x, y, weight, bias=None):
    """``out[b, k] = x[b] @ W[k] @ y[b]`` (+ bias), in float32."""
    out = torch.einsum("bi,kij,bj->bk", x.float(), weight.float(), y.float())
    if bias is not None:
        out = out + bias.float().reshape(1, -1)
    return out.to(x.dtype)


@register_kernel("sequence_mask_op")
def sequence_mask_op(x, max_len=0, out_dtype="int64"):
    """``mask[..., j] = j < x[...]`` over ``max_len`` columns (0: the
    largest length, read on the host)."""
    m = int(max_len)
    if m <= 0:
        _not_captured("sequence_mask_op")
        m = int(x.max())
    row = torch.arange(m, device=x.device)
    return (row < x.long()[..., None]).to(dtype_of(out_dtype or "int64"))


@register_kernel("number_count")
def number_count(numbers, upper_range=1):
    """Tokens an expert: ids outside ``[0, upper_range)`` are dropped."""
    ur = int(upper_range)
    n = numbers.reshape(-1).long()
    n = torch.where((n >= 0) & (n < ur), n, ur)
    # a scatter of ones, not bincount, which reads the max on the host
    return torch.zeros(ur + 1, dtype=torch.int64, device=n.device) \
        .index_add_(0, n, torch.ones_like(n))[:ur]


@register_kernel("seed_op")
def seed_op(seed=0, deterministic=False, force_cpu=False):
    """``[seed]`` (int32), or the port's seed when ``seed`` is 0."""
    s = int(seed) or default_generator(layer_device()).initial_seed()
    return torch.full((1,), s, dtype=torch.int32, device=layer_device())


@register_kernel("full_batch_size_like")
def full_batch_size_like(input, shape=(), value=0.0, dtype=None,
                         input_dim_idx=0, output_dim_idx=0):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return torch.full(tuple(shape), value,
                      dtype=dtype_of(dtype) if dtype else torch.float32,
                      device=input.device)


@register_kernel("row_conv")
def row_conv(x, filter):
    """Lookahead row convolution (DeepSpeech2): ``out[b, t] = sum_i
    x[b, t + i] * filter[i]``, zero beyond T; x ``[B, T, D]``, filter
    ``[future_ctx + 1, D]``, in float32."""
    k = filter.shape[0]
    t = x.shape[1]
    pad = F.pad(x.float(), (0, 0, 0, k - 1))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + pad[:, i:i + t] * filter[i].float()
    return out.to(x.dtype)


@register_kernel("fused_elemwise_add_activation")
def fused_elemwise_add_activation(x, y, functor_list=("relu",)):
    """``act(x + y)`` when the unary functor comes first, ``x + act(y)``
    when the binary one does."""
    fl = list(functor_list or ())
    acts = [f for f in fl if "elementwise" not in f]
    act = acts[0] if acts else ""

    def apply(v):
        if "relu" in act:
            return torch.relu(v)
        if "sigmoid" in act:
            return torch.sigmoid(v)
        if "tanh" in act:
            return torch.tanh(v)
        return v

    if fl and "elementwise" in fl[0]:
        return x + apply(y)
    return apply(x + y)


@register_kernel("margin_cross_entropy")
def margin_cross_entropy(logits, label, return_softmax=False, ring_id=0,
                         rank=0, nranks=1, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0):
    """ArcFace / CosFace combined-margin softmax CE over one shard:
    logits are cosines; the label's class gets ``cos(m1 * theta + m2) -
    m3`` before scaling. Returns ``(softmax, loss [B, 1])``."""
    lab = label.reshape(-1, 1).long()
    cos = logits.float().clamp(-1.0, 1.0)
    tgt = torch.gather(cos, 1, lab).clamp(-1.0 + 1e-6, 1.0 - 1e-6)
    target = torch.cos(margin1 * torch.arccos(tgt) + margin2) - margin3
    adj = cos.scatter(1, lab, target) * scale
    logp = torch.log_softmax(adj, dim=-1)
    loss = -torch.gather(logp, 1, lab)
    return torch.exp(logp).to(logits.dtype), loss.to(logits.dtype)


@register_kernel("hsigmoid_loss")
def hsigmoid_loss(x, label, w, bias=None, path=None, code=None,
                  num_classes=2, is_sparse=False):
    """Hierarchical sigmoid loss: the default complete-binary-tree (heap)
    coding, bits MSB-first over ``ceil(log2(num_classes))`` levels, or a
    custom tree through ``path`` (node ids, -1 padded) and ``code`` (0/1).
    Returns ``(loss [B, 1], sigmoid(pre) [B, L], w)``."""
    lab = label.reshape(-1).long()
    if path is None:
        nc = int(num_classes)
        depth = max(int(np.ceil(np.log2(max(nc, 2)))), 1)
        levels = torch.arange(depth - 1, -1, -1, device=x.device)
        heap = lab[:, None] + nc
        pth = torch.bitwise_right_shift(heap, levels[None, :] + 1) - 1
        cde = (torch.bitwise_right_shift(heap, levels[None, :]) & 1).float()
        valid = pth >= 0
    else:
        pth = path.long()
        cde = code.float()
        valid = pth >= 0
        pth = pth.clamp(min=0)
    pre = torch.einsum("bld,bd->bl", w[pth].float(), x.float())
    if bias is not None:
        pre = pre + bias.reshape(-1)[pth].float()
    bce = pre.clamp(min=0) - pre * cde + torch.log1p(torch.exp(-pre.abs()))
    loss = torch.where(valid, bce, 0.0).sum(dim=1, keepdim=True)
    return loss.to(x.dtype), torch.sigmoid(pre).to(x.dtype), w


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


@register_kernel("graph_khop_sampler")
def graph_khop_sampler(row, colptr, x, eids=None, sample_sizes=(),
                       return_eids=False):
    """Multi-hop sampling and reindexing on the host over
    ``graph_sample_neighbors``: each hop samples the neighbours of the
    last hop's; the seeds, then every node met, get dense local ids in the
    order they are first met. Returns ``(src, dst, sample_index (the node
    of each local id), reindex_x (the seeds' local ids), out_eids)`` in
    x's dtype on x's device."""
    _not_captured("graph_khop_sampler")
    frontier = x
    centers, neighbors, edge_ids = [], [], []
    for hop in sample_sizes:
        nb, cnt, oe = graph_sample_neighbors(row, colptr, frontier, eids,
                                             None, int(hop), return_eids)
        centers.append(np.repeat(_np(frontier).reshape(-1), _np(cnt)))
        neighbors.append(_np(nb))
        if return_eids:
            edge_ids.append(_np(oe))
        frontier = nb
    cen = np.concatenate(centers) if centers else np.zeros(0, np.int64)
    nbs = np.concatenate(neighbors) if neighbors else np.zeros(0, np.int64)
    xs = _np(x).reshape(-1).astype(np.int64)
    met = np.concatenate([xs, nbs.astype(np.int64)])
    _, first = np.unique(met, return_index=True)
    order = met[np.sort(first)]
    by_id = np.argsort(order, kind="stable")

    def local(v):
        v = np.asarray(v, np.int64)
        return by_id[np.searchsorted(order[by_id], v)]

    oe = np.concatenate(edge_ids) if edge_ids else np.zeros(0, np.int64)
    dev, dt = x.device, x.dtype
    return tuple(torch.from_numpy(np.asarray(a, np.int64)).to(dev, dt)
                 for a in (local(nbs), local(cen), order, local(xs), oe))


@register_kernel("lars_momentum_op")
def lars_momentum_op(param, grad, velocity, learning_rate, mu=0.9,
                     lars_coeff=0.001, lars_weight_decay=0.0005,
                     epsilon=0.0, rescale_grad=1.0):
    """Layer-wise adaptive rate scaling: ``local_lr = lr * coeff * ||p|| /
    (||g|| + wd * ||p|| + eps)`` (the plain lr where a norm is 0); returns
    ``(param, velocity float32)``."""
    p = param.float()
    g = grad.float() * rescale_grad
    pn = torch.sqrt((p * p).sum())
    gn = torch.sqrt((g * g).sum())
    lr = learning_rate.float() if isinstance(learning_rate, torch.Tensor) \
        else torch.full((), float(learning_rate), device=p.device)
    local = torch.where((pn > 0) & (gn > 0),
                        lr * lars_coeff * pn
                        / (gn + lars_weight_decay * pn + epsilon), lr)
    v = mu * velocity.float() + local * (g + lars_weight_decay * p)
    return (p - v).to(param.dtype), v


@register_kernel("share_data")
def share_data(x):
    """The input itself (the reference's alias ops are identities)."""
    return x


@register_kernel("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(x, weight, bias=None, stride=(1, 1),
                               padding=(0, 0), output_padding=(0, 0),
                               dilation=(1, 1), groups=1,
                               data_format="NCHW"):
    """``conv2d_transpose`` with one group a channel (``groups`` 1 or None
    mean depthwise); NCHW only, as the reference."""
    if data_format != "NCHW":
        raise NotImplementedError(
            "depthwise_conv2d_transpose: only NCHW is implemented (the "
            "underlying conv2d_transpose kernel is NCHW-fixed)")
    return _conv2d_transpose(
        x, weight, bias, stride=stride, padding=padding,
        output_padding=output_padding, dilation=dilation,
        groups=x.shape[1] if groups in (1, None) else groups)
