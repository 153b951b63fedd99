"""The vision tranche of the op table: sampling, shuffles, pooling with
ceil mode and indices, ``conv3d``, the interpolation family, the
normalization extras, the SSD/RoI box ops and the unified ``batch_norm``.

Counterparts of ``paddle_tpu/ops/kernels/extra_nn.py`` (``ops.yaml``
lines 544-576 and 656). Each is a plain torch composite of the same
arithmetic (convolutions through ``F.conv3d``, windows through the
``F.*_pool*d`` reductions over explicitly padded input), keeping the
reference's conventions where torch's own functions differ:

- ``grid_sample`` defaults to ``align_corners=True`` and gathers the four
  neighbours itself (the reference's clipping and zeroing, not
  ``F.grid_sample``'s);
- ``pool2d`` / ``pool3d`` in ceil mode pad the high side so the last
  partial window survives, and a non-exclusive average divides by the
  whole window (C5); ``max_pool*_with_index`` maxes over zero-padded
  patches and returns flat spatial indices, clipped into the input;
- the ``*_interp`` ops resample as ``jax.image.resize`` /
  ``scale_and_translate`` do: a separable weight matrix per spatial axis
  over pixel centres, the kernel widened (antialiased) when shrinking,
  Keys' cubic with a = -0.5, ``nearest`` at pixel centres, the output size
  ``round(size * scale)``; ``align_corners`` maps corners to corners through
  the same matrices;
- ``segment_pool``, ``roi_align``, ``roi_pool`` and ``prior_box`` read
  sizes or box counts on the host (``jit: false`` in the reference) and
  raise :class:`DataDependentShapeError` while a step is being captured.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dispatcher import register_kernel
from .manipulation import _not_captured
from .nn import _batch_norm_infer, _batch_norm_train, _same_pads


def _ints(v, n=None):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    out = [int(v)] if isinstance(v, (int, np.integer)) else \
        [int(a) for a in v]
    return out * n if n is not None and len(out) == 1 else out


def _to_channels_first(x, data_format):
    return x.movedim(-1, 1) if data_format.endswith("C") else x


def _to_channels_last(x, data_format):
    return x.movedim(1, -1) if data_format.endswith("C") else x


# -- sampling / geometry ------------------------------------------------------

@register_kernel("grid_sample")
def _grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                 align_corners=True):
    """x [N,C,H,W], grid [N,Hg,Wg,2] in [-1,1] -> [N,C,Hg,Wg]."""
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def unnorm(g, size):
        if align_corners:
            return (g + 1.0) * 0.5 * (size - 1)
        return ((g + 1.0) * size - 1.0) * 0.5

    fx, fy = unnorm(gx, W), unnorm(gy, H)
    if padding_mode == "border":
        fx = fx.clamp(0, W - 1)
        fy = fy.clamp(0, H - 1)
    elif padding_mode == "reflection":
        def reflect(f, size):
            if align_corners:
                span = 2 * (size - 1)
                f = torch.remainder(f, span).abs()
                return torch.where(f > size - 1, span - f, f)
            span = 2 * size
            f = torch.remainder((f + 0.5).abs(), span)
            f = torch.where(f > size, span - f, f) - 0.5
            return f.clamp(0, size - 1)
        fx, fy = reflect(fx, W), reflect(fy, H)
    bidx = torch.arange(N, device=x.device)[:, None, None]

    def sample(ix, iy):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        ixc = ix.clamp(0, W - 1).to(torch.int64)
        iyc = iy.clamp(0, H - 1).to(torch.int64)
        v = x[bidx, :, iyc, ixc]                    # [N,Hg,Wg,C]
        return torch.where(inb[..., None], v, 0.0)

    if mode == "nearest":
        out = sample(torch.round(fx), torch.round(fy))
    else:
        x0, y0 = torch.floor(fx), torch.floor(fy)
        x1, y1 = x0 + 1, y0 + 1
        wa = (x1 - fx) * (y1 - fy)
        wb = (fx - x0) * (y1 - fy)
        wc = (x1 - fx) * (fy - y0)
        wd = (fx - x0) * (fy - y0)
        out = (sample(x0, y0) * wa[..., None] + sample(x1, y0) * wb[..., None]
               + sample(x0, y1) * wc[..., None]
               + sample(x1, y1) * wd[..., None])
    return out.movedim(-1, 1).to(x.dtype)


@register_kernel("affine_grid")
def _affine_grid(theta, output_shape=(), align_corners=True):
    """theta [N,2,3], output_shape (N,C,H,W) -> grid [N,H,W,2]."""
    N, _, H, W = _ints(output_shape)

    def lin(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    ys, xs = torch.meshgrid(lin(H), lin(W), indexing="ij")
    base = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)   # [H,W,3]
    grid = torch.einsum("hwk,njk->nhwj", base, theta.float())
    return grid.to(theta.dtype)


# -- shuffles / shifts --------------------------------------------------------

@register_kernel("pixel_unshuffle")
def _pixel_unshuffle(x, downscale_factor=1, data_format="NCHW"):
    x = _to_channels_first(x, data_format)
    out = F.pixel_unshuffle(x, int(downscale_factor))
    return _to_channels_last(out, data_format)


@register_kernel("channel_shuffle")
def _channel_shuffle(x, groups=1, data_format="NCHW"):
    g = int(groups)
    x = _to_channels_first(x, data_format)
    N, C, H, W = x.shape
    out = x.reshape(N, g, C // g, H, W).transpose(1, 2).reshape(N, C, H, W)
    return _to_channels_last(out, data_format)


@register_kernel("temporal_shift")
def _temporal_shift(x, seg_num=1, shift_ratio=0.25, data_format="NCHW"):
    x = _to_channels_first(x, data_format)
    NT, C, H, W = x.shape
    T = int(seg_num)
    c1 = int(C * shift_ratio)
    v = x.reshape(NT // T, T, C, H, W)
    fwd = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(v[:, :1, c1:2 * c1]),
                     v[:, :-1, c1:2 * c1]], 1)
    out = torch.cat([fwd, bwd, v[:, :, 2 * c1:]], dim=2).reshape(NT, C, H, W)
    return _to_channels_last(out, data_format)


@register_kernel("maxout")
def _maxout(x, groups=1, axis=1):
    axis = axis % x.dim()
    g = int(groups)
    shape = x.shape[:axis] + (x.shape[axis] // g, g) + x.shape[axis + 1:]
    return x.reshape(shape).amax(dim=axis + 1)


@register_kernel("pad3d")
def _pad3d(x, paddings=(), mode="constant", value=0.0, data_format="NCDHW"):
    """``paddings`` (left, right, top, bottom, front, back): W, H, D
    order, which is ``F.pad``'s."""
    p = _ints(paddings)
    x = _to_channels_first(x, data_format)
    if mode == "constant":
        out = F.pad(x, p, mode="constant", value=value)
    elif mode in ("reflect", "replicate", "circular"):
        out = F.pad(x, p, mode=mode)
    else:
        raise ValueError(mode)
    return _to_channels_last(out, data_format)


# -- pooling ------------------------------------------------------------------

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_pads(x, ksize, strides, paddings, ceil_mode):
    """Per spatial axis (low, high): ``paddings`` each side, plus in ceil
    mode enough on the high side for the last partial window; and
    whether any window reaches padding."""
    pads, padded = [], bool(any(paddings))
    for i, p in enumerate(paddings):
        hi = p
        if ceil_mode:
            size = x.shape[2 + i] + 2 * p - ksize[i]
            extra = (-(-size // strides[i]) - size // strides[i]) * strides[i]
            hi = p + extra
            padded = padded or extra > 0
        pads.append((p, hi))
    return pads, padded


def _flat_pads(pads):
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _pool_nd(x, ksize, strides, paddings, nd, op, ceil_mode=False,
             exclusive=True):
    """The reference's ``reduce_window`` pool: max over -inf padding, or
    the sum over zeros divided by the window's unpadded elements
    (``exclusive`` where padding is reached) or by the whole window."""
    pads, padded = _window_pads(x, ksize, strides, paddings, ceil_mode)
    flat = _flat_pads(pads)
    xf = x.float()
    if op == "max":
        y = _MAX_POOL[nd](F.pad(xf, flat, value=float("-inf")), ksize,
                          strides)
    else:
        y = _AVG_POOL[nd](F.pad(xf, flat), ksize, strides,
                          divisor_override=1)
        if exclusive and padded:
            ones = F.pad(torch.ones_like(xf[:1, :1]), flat)
            cnt = _AVG_POOL[nd](ones, ksize, strides, divisor_override=1)
            y = y / cnt.clamp(min=1.0)
        else:
            y = y / float(np.prod(ksize))
    return y.to(x.dtype)


def _adaptive_pool(x, out_size, pooling_type):
    """Exact bins over divisible sizes (the reference's restriction)."""
    spatial = x.shape[2:]
    out_size = _ints(out_size, len(spatial))
    for s, o in zip(spatial, out_size):
        if s % o:
            raise ValueError("adaptive pool needs divisible sizes")
    view = x.reshape(tuple(x.shape[:2]) + tuple(
        d for s, o in zip(spatial, out_size) for d in (o, s // o)))
    axes = tuple(3 + 2 * i for i in range(len(spatial)))
    return view.amax(dim=axes) if pooling_type == "max" \
        else view.mean(dim=axes)


def _pool(x, nd, kernel_size, strides, paddings, pooling_type, ceil_mode,
          exclusive, adaptive, global_pooling, data_format):
    x = _to_channels_first(x, data_format)
    if global_pooling:
        kernel_size, paddings = list(x.shape[2:]), [0] * nd
    if adaptive:
        out = _adaptive_pool(x, kernel_size, pooling_type)
    else:
        k = _ints(kernel_size, nd)
        st = _ints(strides, nd) if len(_ints(strides)) else k
        out = _pool_nd(x, k, st, _ints(paddings, nd), nd,
                       "avg" if pooling_type == "avg" else "max",
                       ceil_mode, exclusive)
    return _to_channels_last(out, data_format)


@register_kernel("pool2d")
def _pool2d(x, kernel_size=(), strides=(), paddings=(0, 0),
            pooling_type="max", ceil_mode=False, exclusive=True,
            adaptive=False, global_pooling=False, data_format="NCHW"):
    return _pool(x, 2, kernel_size, strides, paddings, pooling_type,
                 ceil_mode, exclusive, adaptive, global_pooling, data_format)


@register_kernel("pool3d")
def _pool3d(x, kernel_size=(), strides=(), paddings=(0, 0, 0),
            pooling_type="max", ceil_mode=False, exclusive=True,
            adaptive=False, global_pooling=False, data_format="NCDHW"):
    return _pool(x, 3, kernel_size, strides, paddings, pooling_type,
                 ceil_mode, exclusive, adaptive, global_pooling, data_format)


def _patches(x, ksize, strides, paddings):
    """Zero-padded windows ``[N, C, prod(k), *out]``, kernel positions in
    row-major order (the reference's ``conv_general_dilated_patches``)."""
    nd = len(ksize)
    xp = F.pad(x.float(), _flat_pads([(p, p) for p in paddings]))
    out = [(xp.shape[2 + i] - ksize[i]) // strides[i] + 1 for i in range(nd)]
    cols = []
    for off in np.ndindex(*ksize):
        idx = (slice(None), slice(None)) + tuple(
            slice(o, o + (n - 1) * s + 1, s)
            for o, n, s in zip(off, out, strides))
        cols.append(xp[idx])
    return torch.stack(cols, dim=2)


def _pool_with_index(x, ksize, strides, paddings):
    """Max pool and the flat spatial index of each window's first max
    (reference ``max_pool2d_with_index``): window-relative argmax made
    global, each coordinate clipped into the input."""
    nd = len(ksize)
    patches = _patches(x, ksize, strides, paddings)
    out = patches.amax(dim=2)
    arg = patches.argmax(dim=2)
    out_sp = patches.shape[3:]
    grids = torch.meshgrid(*[torch.arange(o, device=x.device)
                             for o in out_sp], indexing="ij")
    flat = torch.zeros_like(arg)
    rem = arg
    coords = []
    for dim in reversed(range(nd)):
        coords.append(rem % ksize[dim])
        rem = rem // ksize[dim]
    coords = coords[::-1]
    for dim in range(nd):
        pos = grids[dim] * strides[dim] - paddings[dim] + coords[dim]
        pos = pos.clamp(0, x.shape[2 + dim] - 1)
        flat = flat * x.shape[2 + dim] + pos
    return out.to(x.dtype), flat


def _with_index(x, nd, kernel_size, strides, paddings, global_pooling):
    if global_pooling:
        kernel_size, paddings = list(x.shape[2:]), [0] * nd
    k = _ints(kernel_size, nd)
    st = _ints(strides, nd) if len(_ints(strides)) else k
    return _pool_with_index(x, k, st, _ints(paddings, nd))


@register_kernel("max_pool2d_with_index")
def _max_pool2d_with_index(x, kernel_size=(), strides=(), paddings=(0, 0),
                           global_pooling=False, adaptive=False):
    return _with_index(x, 2, kernel_size, strides, paddings, global_pooling)


@register_kernel("max_pool3d_with_index")
def _max_pool3d_with_index(x, kernel_size=(), strides=(),
                           paddings=(0, 0, 0), global_pooling=False,
                           adaptive=False):
    return _with_index(x, 3, kernel_size, strides, paddings, global_pooling)


def _unpool(x, indices, output_size, nd):
    """Scatter each value to its flat spatial index (the inverse of
    ``max_pool*_with_index``) in an output of ``output_size``."""
    N, C = x.shape[:2]
    sp = _ints(output_size)[-nd:]
    flat = x.new_zeros((N, C, int(np.prod(sp))))
    idx = indices.reshape(N, C, -1).to(torch.int64)
    out = flat.scatter(2, idx, x.reshape(N, C, -1))
    return out.reshape((N, C) + tuple(sp))


@register_kernel("unpool")
def _unpool2d(x, indices, kernel_size=(), strides=(), paddings=(0, 0),
              output_size=()):
    return _unpool(x, indices, output_size, 2)


@register_kernel("unpool3d")
def _unpool3d(x, indices, kernel_size=(), strides=(), paddings=(0, 0, 0),
              output_size=()):
    return _unpool(x, indices, output_size, 3)


@register_kernel("fold")
def _fold(x, output_sizes=(), kernel_sizes=(), strides=(1, 1),
          paddings=(0, 0), dilations=(1, 1)):
    """col2im: ``[N, C·kh·kw, L]`` -> ``[N, C, H, W]``, overlaps summed
    (``F.fold``, C major as ``unfold``)."""
    return F.fold(x, _ints(output_sizes, 2), _ints(kernel_sizes, 2),
                  _ints(dilations, 2), _ints(paddings, 2), _ints(strides, 2))


@register_kernel("fractional_max_pool2d")
def _fractional_max_pool2d(x, output_size=(), kernel_size=None,
                           random_u=0.5, return_mask=False):
    """Region edges from the pseudo-random sequence at the given ``u``
    (``kernel_size`` caps each region); ``return_mask`` adds the flat
    spatial index of each region's first max."""
    N, C, H, W = x.shape
    oh, ow = _ints(output_size, 2)
    u = float(random_u)
    eh = np.floor((H / oh) * (np.arange(oh + 1) + u)).astype(int)
    eh = np.clip(eh - eh[0], 0, H)
    ew = np.floor((W / ow) * (np.arange(ow + 1) + u)).astype(int)
    ew = np.clip(ew - ew[0], 0, W)
    eh[-1], ew[-1] = H, W
    kh = kw = None
    if kernel_size:
        kh, kw = _ints(kernel_size, 2)
    rows, mrows = [], []
    for i in range(oh):
        cols, mcols = [], []
        h0, h1 = int(eh[i]), int(max(eh[i + 1], eh[i] + 1))
        if kh:
            h1 = min(h0 + kh, H)
        for j in range(ow):
            w0, w1 = int(ew[j]), int(max(ew[j + 1], ew[j] + 1))
            if kw:
                w1 = min(w0 + kw, W)
            flat = x[:, :, h0:h1, w0:w1].reshape(N, C, -1)
            cols.append(flat.amax(dim=-1))
            arg = flat.argmax(dim=-1)
            mcols.append((arg // (w1 - w0) + h0) * W + (arg % (w1 - w0) + w0))
        rows.append(torch.stack(cols, dim=-1))
        mrows.append(torch.stack(mcols, dim=-1))
    out = torch.stack(rows, dim=-2)
    if return_mask:
        return out, torch.stack(mrows, dim=-2)
    return out


# -- conv3d -------------------------------------------------------------------

@register_kernel("conv3d")
def _conv3d(x, weight, stride=(1, 1, 1), padding=(0, 0, 0),
            dilation=(1, 1, 1), groups=1, data_format="NCDHW"):
    """One ``F.conv3d`` (kernel ``[out, in/groups, kd, kh, kw]``);
    ``padding`` ints or "SAME" / "VALID"."""
    x = _to_channels_first(x, data_format)
    st, dl = _ints(stride, 3), _ints(dilation, 3)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = [(0, 0)] * 3
        else:
            pads = [_same_pads(x.shape[2 + i], weight.shape[2 + i], st[i],
                               dl[i]) for i in range(3)]
        x = F.pad(x, _flat_pads(pads))
        out = F.conv3d(x, weight, None, st, 0, dl, int(groups))
    else:
        out = F.conv3d(x, weight, None, st, _ints(padding, 3), dl,
                       int(groups))
    return _to_channels_last(out, data_format)


@register_kernel("conv3d_transpose")
def _conv3d_transpose(x, weight, stride=(1, 1, 1), padding=(0, 0, 0),
                      output_padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                      data_format="NCDHW"):
    """``F.conv_transpose3d``: the kernel ``[in, out/groups, kd, kh, kw]``
    in Paddle's layout, which is torch's."""
    x = _to_channels_first(x, data_format)
    out = F.conv_transpose3d(x, weight, None, _ints(stride, 3),
                             _ints(padding, 3), _ints(output_padding, 3),
                             int(groups), _ints(dilation, 3))
    return _to_channels_last(out, data_format)


# -- interpolation ------------------------------------------------------------

def _triangle(t):
    return (1 - t.abs()).clamp(min=0)


def _keys_cubic(t):
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _weight_mat(n_in, n_out, scale, translation, kernel, device):
    """``jax.image``'s ``compute_weight_mat``: ``[n_in, n_out]`` weights
    of each output sample over the input pixel centres, the kernel widened
    by 1/scale when shrinking, each column normalized, samples outside the
    input zeroed."""
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv - translation * inv - 0.5)
    t = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kscale
    w = kernel(t)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _div(a, b):
    """``a / b`` for a python number ``b``, as a true division on every
    device (CUDA multiplies by the reciprocal of a host scalar, one bit
    off, which moves a floor or a ceil taken of the result)."""
    return a / torch.full_like(a, float(b))


def _nearest_index(n_in, n_out, device):
    """``jax.image``'s nearest: the input pixel under each output pixel's
    centre, ``floor((i + 0.5) * in / out)`` in float32."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * float(n_in)
    return torch.floor(_div(pos, n_out)).to(torch.int64)


def _interp(x, size, scale, method, align_corners, nd, data_format):
    x = _to_channels_first(x, data_format)
    spatial = x.shape[2:]
    if size is not None and len(_ints(size)):
        out_sp = _ints(size, nd)
    else:
        sc = ([float(scale)] * nd if np.isscalar(scale)
              else [float(s) for s in (scale.tolist()
                                       if isinstance(scale, torch.Tensor)
                                       else scale)])
        out_sp = [int(round(s * c)) for s, c in zip(spatial, sc)]
    out = x.float()
    if method == "nearest":
        for i, (s, o) in enumerate(zip(spatial, out_sp)):
            if s != o:
                out = out.index_select(2 + i,
                                       _nearest_index(s, o, x.device))
        return _to_channels_last(out.to(x.dtype), data_format)
    kernel = _keys_cubic if method == "bicubic" else _triangle
    for i, (s, o) in enumerate(zip(spatial, out_sp)):
        if align_corners:
            k = (o - 1) / (s - 1) if s > 1 else 1.0
            w = _weight_mat(s, o, float(np.float32(k)),
                            float(np.float32(0.5 * (1.0 - k))), kernel,
                            x.device)
        elif s == o:
            continue
        else:
            w = _weight_mat(s, o, o / s, 0.0, kernel, x.device)
        out = torch.tensordot(out, w, dims=([2 + i], [0])).movedim(-1, 2 + i)
    return _to_channels_last(out.to(x.dtype), data_format)


@register_kernel("bilinear_interp")
def _bilinear_interp(x, size=None, scale_factor=None, align_corners=False,
                     data_format="NCHW"):
    return _interp(x, size, scale_factor, "bilinear", align_corners, 2,
                   data_format)


@register_kernel("nearest_interp")
def _nearest_interp(x, size=None, scale_factor=None, align_corners=False,
                    data_format="NCHW"):
    return _interp(x, size, scale_factor, "nearest", align_corners, 2,
                   data_format)


@register_kernel("bicubic_interp")
def _bicubic_interp(x, size=None, scale_factor=None, align_corners=False,
                    data_format="NCHW"):
    return _interp(x, size, scale_factor, "bicubic", align_corners, 2,
                   data_format)


@register_kernel("linear_interp")
def _linear_interp(x, size=None, scale_factor=None, align_corners=False,
                   data_format="NCW"):
    return _interp(x, size, scale_factor, "linear", align_corners, 1,
                   data_format)


@register_kernel("trilinear_interp")
def _trilinear_interp(x, size=None, scale_factor=None, align_corners=False,
                      data_format="NCDHW"):
    return _interp(x, size, scale_factor, "trilinear", align_corners, 3,
                   data_format)


# -- normalization extras -----------------------------------------------------

@register_kernel("spectral_norm")
def _spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    """``weight`` over its largest singular value from ``power_iters``
    power iterations (grads flow through them, as in the reference)."""
    w = weight.movedim(dim, 0)
    mat = w.reshape(w.shape[0], -1).float()
    uu, vv = u.float(), v.float()
    for _ in range(int(power_iters)):
        vv = mat.T @ uu
        vv = vv / torch.linalg.norm(vv).clamp(min=eps)
        uu = mat @ vv
        uu = uu / torch.linalg.norm(uu).clamp(min=eps)
    sigma = uu @ mat @ vv
    return weight / sigma.to(weight.dtype)


@register_kernel("segment_pool")
def _segment_pool(x, segment_ids, pooltype="SUM"):
    """Rows of ``x`` pooled by segment id; the output has max id + 1 rows,
    read on the host."""
    _not_captured("segment_pool")
    ids = segment_ids.to(device=x.device, dtype=torch.int64)
    n = int(ids.max()) + 1 if ids.numel() else 0
    shape = (n,) + tuple(x.shape[1:])
    idx = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    if pooltype in ("SUM", "MEAN"):
        out = x.new_zeros(shape).index_add(0, ids, x)
        if pooltype == "MEAN":
            c = x.new_zeros(n).index_add(0, ids, x.new_ones(x.shape[0]))
            out = out / c.clamp(min=1.0).reshape((-1,) + (1,) * (x.dim() - 1))
        return out
    if pooltype in ("MAX", "MIN"):
        fill = float("-inf") if pooltype == "MAX" else float("inf")
        return x.new_full(shape, fill).scatter_reduce(
            0, idx, x, "amax" if pooltype == "MAX" else "amin",
            include_self=False)
    raise ValueError(pooltype)


@register_kernel("overlap_add")
def _overlap_add(x, hop_length=1, axis=-1):
    """``[..., n_frames, frame_len]`` -> ``[..., (n - 1) * hop + len]``,
    overlaps summed (``axis`` 0: frames leading)."""
    if axis == 0:
        x = x.movedim((0, 1), (-1, -2))
    frame_len, n = x.shape[-1], x.shape[-2]
    hop = int(hop_length)
    batch = tuple(x.shape[:-2])
    flat = x.reshape((-1, n, frame_len)).transpose(1, 2)    # [B, len, n]
    out = F.fold(flat, (1, (n - 1) * hop + frame_len), (1, frame_len),
                 stride=(1, hop))
    out = out.reshape(batch + (-1,))
    if axis == 0:
        out = out.movedim(-1, 0)
    return out


# -- detection ----------------------------------------------------------------

@register_kernel("box_coder")
def _box_coder(prior_box, prior_box_var=None, target_box=None,
               code_type="encode_center_size", box_normalized=True, axis=0):
    pb = prior_box.float()
    tb = target_box.float()
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    px = pb[:, 0] + pw * 0.5
    py = pb[:, 1] + ph * 0.5
    var = prior_box_var.float() if prior_box_var is not None \
        else torch.ones((1, 4), device=pb.device)
    if code_type.startswith("encode"):
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tx = tb[:, 0] + tw * 0.5
        ty = tb[:, 1] + th * 0.5
        out = torch.stack([(tx[:, None] - px[None]) / pw[None],
                           (ty[:, None] - py[None]) / ph[None],
                           torch.log(tw[:, None] / pw[None]),
                           torch.log(th[:, None] / ph[None])], dim=-1)
        return out / var.reshape(1, -1, 4)
    d = tb * var.reshape(1, -1, 4) if prior_box_var is not None else tb
    if axis == 0:
        pw_, ph_, px_, py_ = (v[:, None] for v in (pw, ph, px, py))
    else:
        pw_, ph_, px_, py_ = (v[None, :] for v in (pw, ph, px, py))
    cx = d[..., 0] * pw_ + px_
    cy = d[..., 1] * ph_ + py_
    w = torch.exp(d[..., 2]) * pw_
    h = torch.exp(d[..., 3]) * ph_
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=-1)


def _box_images(boxes_num, k, device):
    """The image of each box, from the per-image box counts (host)."""
    if boxes_num is None:
        return torch.zeros(k, dtype=torch.int64, device=device)
    counts = np.asarray(boxes_num.detach().cpu() if isinstance(
        boxes_num, torch.Tensor) else boxes_num).astype(np.int64)
    return torch.from_numpy(np.repeat(np.arange(len(counts)), counts)).to(
        device)


@register_kernel("roi_align")
def _roi_align(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
               spatial_scale=1.0, sampling_ratio=-1, aligned=True):
    """``[N,C,H,W]`` + ``[K,4]`` boxes -> ``[K,C,ph,pw]``: the mean of s x s
    bilinear samples a bin (s = ``sampling_ratio``, else 2), gathered at
    the samples only (no per-box copy of the image)."""
    _not_captured("roi_align")
    N, C, H, W = x.shape
    K = boxes.shape[0]
    ph, pw = int(pooled_height), int(pooled_width)
    bidx = _box_images(boxes_num, K, x.device)
    off = 0.5 if aligned else 0.0
    b = boxes.float() * float(spatial_scale) - off
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bw = (x1 - x0).clamp(min=1e-3 if aligned else 1.0)
    bh = (y1 - y0).clamp(min=1e-3 if aligned else 1.0)
    s = int(sampling_ratio) if int(sampling_ratio) > 0 else 2
    dev = x.device
    gy = y0[:, None] + (torch.arange(ph * s, device=dev) + 0.5)[None, :] \
        * _div(bh, ph * s)[:, None]
    gx = x0[:, None] + (torch.arange(pw * s, device=dev) + 0.5)[None, :] \
        * _div(bw, pw * s)[:, None]
    yy0 = torch.floor(gy).clamp(0, H - 1)
    xx0 = torch.floor(gx).clamp(0, W - 1)
    yy1 = (yy0 + 1).clamp(0, H - 1)
    xx1 = (xx0 + 1).clamp(0, W - 1)
    wy = (gy - yy0).clamp(0, 1)[:, :, None, None]            # [K,Sy,1,1]
    wx = (gx - xx0).clamp(0, 1)[:, None, :, None]            # [K,1,Sx,1]
    xf = x.float()
    bi = bidx[:, None, None]
    i = lambda a: a.to(torch.int64)  # noqa: E731

    def at(yy, xx):                                          # [K,Sy,Sx,C]
        return xf[bi, :, i(yy)[:, :, None], i(xx)[:, None, :]]

    samp = (at(yy0, xx0) * ((1 - wy) * (1 - wx))
            + at(yy0, xx1) * ((1 - wy) * wx)
            + at(yy1, xx0) * (wy * (1 - wx))
            + at(yy1, xx1) * (wy * wx))
    out = samp.reshape(K, ph, s, pw, s, C).mean(dim=(2, 4))
    return out.permute(0, 3, 1, 2).to(x.dtype)


@register_kernel("roi_pool")
def _roi_pool(x, boxes, boxes_num=None, pooled_height=1, pooled_width=1,
              spatial_scale=1.0):
    """Max over quantized bins (reference ``roi_pool``): each box's
    corners rounded and read on the host, its region's bins maxed by
    masks over the region."""
    _not_captured("roi_pool")
    N, C, H, W = x.shape
    K = boxes.shape[0]
    ph, pw = int(pooled_height), int(pooled_width)
    bidx = _box_images(boxes_num, K, "cpu").tolist()
    b = torch.round(boxes.float() * float(spatial_scale)).cpu()
    x0 = b[:, 0].clamp(0, W - 1).to(torch.int64).tolist()
    y0 = b[:, 1].clamp(0, H - 1).to(torch.int64).tolist()
    x1 = b[:, 2].clamp(0, W - 1).to(torch.int64).tolist()
    y1 = b[:, 3].clamp(0, H - 1).to(torch.int64).tolist()
    outs = []
    for k in range(K):
        hs_, he_ = y0[k], max(y1[k], y0[k])
        ws_, we_ = x0[k], max(x1[k], x0[k])
        bh, bw = max(y1[k] - y0[k] + 1, 1), max(x1[k] - x0[k] + 1, 1)
        region = x[bidx[k], :, hs_:he_ + 1, ws_:we_ + 1].float()
        ys = np.arange(hs_, he_ + 1)[None, :]
        xs = np.arange(ws_, we_ + 1)[None, :]
        i = np.arange(ph)[:, None]
        j = np.arange(pw)[:, None]
        hs = y0[k] + (i * bh) // ph
        he = y0[k] + ((i + 1) * bh + ph - 1) // ph
        wss = x0[k] + (j * bw) // pw
        wse = x0[k] + ((j + 1) * bw + pw - 1) // pw
        rm = (ys >= hs) & (ys < np.maximum(he, hs + 1))          # [ph, h]
        cm = (xs >= wss) & (xs < np.maximum(wse, wss + 1))       # [pw, w]
        m = torch.from_numpy(rm[:, None, :, None] & cm[None, :, None, :]) \
            .to(x.device)                                        # [ph,pw,h,w]
        v = torch.where(m[None], region[:, None, None], float("-inf"))
        outs.append(v.amax(dim=(3, 4)))
    if not outs:
        return x.new_zeros((0, C, ph, pw))
    return torch.stack(outs).to(x.dtype)


@register_kernel("prior_box")
def _prior_box(input, image, min_sizes=(), max_sizes=(), aspect_ratios=(1.0,),
               variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
               steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False):
    """SSD prior boxes ``[fh, fw, priors, 4]`` and their variances, built on
    the host from the two shapes."""
    _not_captured("prior_box")
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    steps = list(steps)
    sw = float(steps[0]) or iw / fw
    sh = float(steps[1]) or ih / fh
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
    boxes = []
    for s_i, ms in enumerate(min_sizes):
        ms = float(ms)
        boxes.append((ms, ms))
        if max_sizes:
            mx = float(max_sizes[s_i])
            boxes.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            boxes.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
    num_priors = len(boxes)
    cx = (np.arange(fw) + float(offset)) * sw
    cy = (np.arange(fh) + float(offset)) * sh
    gx, gy = np.meshgrid(cx, cy)
    out = np.zeros((fh, fw, num_priors, 4), np.float32)
    for p, (bw, bh) in enumerate(boxes):
        out[:, :, p, 0] = (gx - bw / 2) / iw
        out[:, :, p, 1] = (gy - bh / 2) / ih
        out[:, :, p, 2] = (gx + bw / 2) / iw
        out[:, :, p, 3] = (gy + bh / 2) / ih
    if clip:
        out = out.clip(0.0, 1.0)
    var = np.tile(np.asarray(variances, np.float32), (fh, fw, num_priors, 1))
    return (torch.from_numpy(out).to(input.device),
            torch.from_numpy(var).to(input.device))


@register_kernel("batch_norm")
def _batch_norm(x, mean, variance, scale=None, bias=None, is_test=False,
                momentum=0.9, epsilon=1e-05, data_format="NCHW",
                use_global_stats=False):
    """The unified ``batch_norm`` op: ``(out, mean_out, variance_out,
    saved_mean, saved_variance)``; in training the running statistics
    fold the batch's by ``momentum`` (Paddle's: ``running * m + batch *
    (1 - m)``)."""
    if is_test or use_global_stats:
        out = _batch_norm_infer(x, mean, variance, scale, bias, epsilon,
                                data_format)
        return out, mean, variance, mean, variance
    out, bmean, bvar = _batch_norm_train(x, scale, bias, epsilon, data_format)
    m = float(momentum)
    return (out, mean * m + bmean * (1 - m), variance * m + bvar * (1 - m),
            bmean, bvar)


@register_kernel("viterbi_decode")
def _viterbi_decode(potentials, transition, lengths=None,
                    include_bos_eos_tag=True):
    """CRF Viterbi decoding: ``text.viterbi_decode``, as the reference's
    op delegates to its ``text`` module."""
    from ...text import _viterbi
    return _viterbi(potentials, transition, lengths, include_bos_eos_tag)
