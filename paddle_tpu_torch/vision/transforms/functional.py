"""Functional image transforms (counterpart of
``paddle_tpu/vision/transforms/functional.py``). The transforms run on the
host in numpy, as the reference's do, on HWC uint8 or float arrays (Paddle's
"cv2 backend"), so a DataLoader's worker processes run them and the card is
left to the training step; under the same ``random.seed`` /
``np.random.seed`` they give the reference's pixels. ``to_tensor`` is the
one boundary to a ``Tensor``: CHW float32 on ``set_device``'s device (the
card unless the caller chose the CPU); ``normalize`` and ``erase`` also
take a ``Tensor``.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ...core.tensor import to_tensor as _to_tensor

__all__ = [
    "to_tensor", "resize", "pad", "crop", "center_crop", "hflip", "vflip",
    "adjust_brightness", "adjust_contrast", "adjust_saturation", "adjust_hue",
    "rotate", "to_grayscale", "normalize", "erase",
]


def _as_hwc(img):
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(pic, data_format="CHW"):
    """HWC uint8/float image -> float32 Tensor scaled to [0,1] (CHW default).

    Reference: vision/transforms/functional.py ``to_tensor``.
    """
    img = _as_hwc(pic)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format.upper() == "CHW":
        img = np.transpose(img, (2, 0, 1))
    return _to_tensor(np.ascontiguousarray(img))


def _bilinear_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    # half-pixel-centers bilinear, matching cv2.resize/INTER_LINEAR semantics
    ys = (np.arange(h, dtype=np.float64) + 0.5) * ih / h - 0.5
    xs = (np.arange(w, dtype=np.float64) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    im = img.astype(np.float64)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(img.dtype)
    return out


def _nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ih, iw = img.shape[:2]
    ys = np.minimum((np.arange(h) * ih // h), ih - 1)
    xs = np.minimum((np.arange(w) * iw // w), iw - 1)
    return img[ys][:, xs]


def resize(img, size, interpolation="bilinear"):
    """size: int (shorter edge) or (h, w)."""
    img = _as_hwc(img)
    ih, iw = img.shape[:2]
    if isinstance(size, int):
        if ih <= iw:
            h, w = size, max(1, int(round(iw * size / ih)))
        else:
            h, w = max(1, int(round(ih * size / iw))), size
    else:
        h, w = int(size[0]), int(size[1])
    if interpolation in ("nearest",):
        return _nearest_resize(img, h, w)
    return _bilinear_resize(img, h, w)


def pad(img, padding, fill=0, padding_mode="constant"):
    img = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    pads = ((pt, pb), (pl, pr), (0, 0))
    if padding_mode == "constant":
        return np.pad(img, pads, mode="constant", constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, pads, mode=mode)


def crop(img, top, left, height, width):
    img = _as_hwc(img)
    return img[top:top + height, left:left + width]


def center_crop(img, output_size):
    img = _as_hwc(img)
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    h, w = img.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(img, top, left, th, tw)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


def _hi(img):
    """Value ceiling by dtype: uint8 images live in [0,255], float in [0,1]."""
    return 255.0 if img.dtype == np.uint8 else 1.0


def _blend(img1, img2, ratio):
    out = img1.astype(np.float64) * ratio + img2.astype(np.float64) * (1 - ratio)
    if img1.dtype == np.uint8:
        return np.clip(out, 0, 255).astype(np.uint8)
    return np.clip(out, 0.0, 1.0).astype(img1.dtype)


def adjust_brightness(img, brightness_factor):
    img = _as_hwc(img)
    return _blend(img, np.zeros_like(img), brightness_factor)


def adjust_contrast(img, contrast_factor):
    img = _as_hwc(img)
    mean = to_grayscale(img).mean()
    fill = (np.full_like(img, int(round(mean))) if img.dtype == np.uint8
            else np.full_like(img, mean))
    return _blend(img, fill, contrast_factor)


def adjust_saturation(img, saturation_factor):
    img = _as_hwc(img)
    gray = to_grayscale(img, num_output_channels=img.shape[2])
    return _blend(img, gray, saturation_factor)


def adjust_hue(img, hue_factor):
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor is not in [-0.5, 0.5].")
    img = _as_hwc(img)
    hi = _hi(img)
    hsv = _rgb_to_hsv(img.astype(np.float64) / hi)
    hsv[..., 0] = (hsv[..., 0] + hue_factor) % 1.0
    out = _hsv_to_rgb(hsv)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)
    return np.clip(out, 0.0, 1.0).astype(img.dtype)


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, (h / 6.0) % 1.0)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int64) % 6
    choices = [np.stack(c, -1) for c in
               [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]]
    out = np.zeros_like(hsv)
    for k, c in enumerate(choices):
        out = np.where((i == k)[..., None], c, out)
    return out


def rotate(img, angle, interpolation="nearest", expand=False, center=None, fill=0):
    """Rotate counter-clockwise by ``angle`` degrees."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    theta = np.deg2rad(angle)
    cos, sin = np.cos(theta), np.sin(theta)
    if center is None:
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    else:
        cx, cy = center
    if expand:
        nw = int(np.ceil(abs(w * cos) + abs(h * sin)))
        nh = int(np.ceil(abs(w * sin) + abs(h * cos)))
    else:
        nw, nh = w, h
    ox, oy = (nw - 1) / 2.0, (nh - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(nh), np.arange(nw), indexing="ij")
    # inverse map: output coord -> input coord
    xi = (xx - ox) * cos - (yy - oy) * sin + cx
    yi = (xx - ox) * sin + (yy - oy) * cos + cy
    out = np.full((nh, nw, img.shape[2]), fill, dtype=img.dtype)
    if interpolation == "bilinear":
        x0 = np.floor(xi).astype(np.int64)
        y0 = np.floor(yi).astype(np.int64)
        valid = (x0 >= 0) & (x0 + 1 < w) & (y0 >= 0) & (y0 + 1 < h)
        x0c, y0c = np.clip(x0, 0, w - 2), np.clip(y0, 0, h - 2)
        fx = (xi - x0)[..., None]
        fy = (yi - y0)[..., None]
        im = img.astype(np.float64)
        val = (im[y0c, x0c] * (1 - fx) * (1 - fy)
               + im[y0c, x0c + 1] * fx * (1 - fy)
               + im[y0c + 1, x0c] * (1 - fx) * fy
               + im[y0c + 1, x0c + 1] * fx * fy)
        if img.dtype == np.uint8:
            val = np.clip(np.rint(val), 0, 255).astype(np.uint8)
        else:
            val = val.astype(img.dtype)
        out[valid] = val[valid]
    else:
        xn = np.rint(xi).astype(np.int64)
        yn = np.rint(yi).astype(np.int64)
        valid = (xn >= 0) & (xn < w) & (yn >= 0) & (yn < h)
        out[valid] = img[yn[valid], xn[valid]]
    return out


def to_grayscale(img, num_output_channels=1):
    img = _as_hwc(img)
    if img.shape[2] == 1:
        gray = img.astype(np.float64)[..., 0]
    else:
        gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2]).astype(np.float64)
    if img.dtype == np.uint8:
        gray = np.clip(np.rint(gray), 0, 255).astype(np.uint8)[..., None]
    else:
        gray = gray.astype(img.dtype)[..., None]
    return np.repeat(gray, num_output_channels, axis=2)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    shape = (-1, 1, 1) if data_format.upper() == "CHW" else (1, 1, -1)
    if isinstance(img, torch.Tensor):
        if to_rgb:
            img = img.flip(0 if data_format.upper() == "CHW" else -1)
        mean = torch.as_tensor(np.asarray(mean, np.float32).reshape(shape))
        std = torch.as_tensor(np.asarray(std, np.float32).reshape(shape))
        return (img - mean.to(img.device)) / std.to(img.device)
    if to_rgb:
        # BGR (cv2-loaded) -> RGB channel flip before per-channel stats
        img = np.asarray(img)
        img = img[::-1] if data_format.upper() == "CHW" else img[..., ::-1]
    img = np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    return (img - mean.reshape(shape)) / std.reshape(shape)


def erase(img, i, j, h, w, v, inplace=False):
    if isinstance(img, torch.Tensor):
        out = img if inplace else img.clone()
        out[..., i:i + h, j:j + w] = v if not isinstance(v, np.ndarray) \
            else torch.as_tensor(v).to(out.device)
        return out
    img = img if inplace else img.copy()
    img[i:i + h, j:j + w] = v
    return img
