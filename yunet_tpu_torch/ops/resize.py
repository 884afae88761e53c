"""Bilinear resize with ``cv2.resize(img, (w, h))``'s semantics (the
default ``INTER_LINEAR``), in PyTorch tensor ops, so that a host without
OpenCV resizes to the same bytes.

What OpenCV does, and this module reproduces (``modules/imgproc/src/
resize.cpp``):

  * **Pixel centres.** The scale of an axis is ``1 / (dst / src)`` in
    double; destination index d samples ``f = float((d + 0.5) * scale -
    0.5)`` at ``s = floor(f)`` with weight ``f - s`` on ``s + 1``. Along x
    a sample left of pixel 0 or right of the last one takes that pixel
    with weight 1. Along y the rows are clamped and the weights are not.
  * **Fixed point for uint8.** The weights are rounded to 11 bits
    (``INTER_RESIZE_COEF_BITS``): ``rint(w * 2048)``. The horizontal pass
    sums in int32. The vertical pass is OpenCV's vector route
    (``VResizeLinearVec_32s8u``): each row sum is shifted right by 4,
    multiplied by its 11-bit weight keeping the high 16 bits, and the two
    are added and rounded by a shift of 2. Every truncation is an
    arithmetic shift of a non-negative int32, so the CPU and the card give
    the same bytes.
  * **Exact 2x downscale.** When the scale is exactly 2 on both axes
    OpenCV swaps INTER_LINEAR for INTER_AREA: the mean of each 2x2 block,
    ``(a + b + c + d + 2) >> 2`` for uint8.
  * **Float images** (f32, f64) take the same centres, with coordinates
    and weights in double, summed in f64 and rounded once to the image's
    dtype. OpenCV's float route (Intel IPP in the opencv-python builds)
    rounds inside its sums in its own way: an f32 result can be a few
    ulps off (under 5e-5 at 255), never a grey level.

``resize_area`` reproduces ``cv2.resize(img, dsize,
interpolation=cv2.INTER_AREA)`` for uint8, in its three routes:

  * **Integer scales** on both axes (``is_area_fast``): the mean of each
    block. 2x2 is ``(a + b + c + d + 2) >> 2`` (OpenCV's vector route);
    any other block is its int sum times ``float(1 / area)`` in f32,
    rounded half to even (``resizeAreaFast_``).
  * **Downscale** on both axes, not integer (``computeResizeAreaTab``):
    a table of (destination, source, alpha) per axis built in double,
    each alpha rounded to f32. The horizontal pass accumulates
    ``buf += S * alpha`` in f32 in table order; the vertical pass sets
    ``sum = beta * buf`` for a row's first tap and adds ``beta * buf``
    for the rest, in f32; ``rint`` rounds the result. A naive f64 area
    mean is one level off on ~0.05% of pixels, so the order matters.
  * **Upscale** on either axis: the fixed-point linear route above, with
    INTER_AREA's coefficients on both axes: ``s = floor(d * scale)``,
    ``f = (d + 1) - (s + 1) / scale``, ``f = 0 if f <= 0 else f -
    floor(f)``.
"""

from __future__ import annotations

import math
import sys
from typing import Tuple

import numpy as np
import torch

COEF_BITS = 11                       # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _axis(src: int, dst: int, *, clamp_weight: bool, dtype=np.float32,
          area: bool = False):
    """(index of the first tap, index of the second, weight of the first,
    weight of the second) for each of ``dst`` outputs along an axis of
    ``src`` pixels. dtype f32 rounds the coordinate and the weights to f32,
    as OpenCV's fixed-point route does (``cbuf``); f64 keeps them in
    double. area: INTER_AREA's coefficients (OpenCV's ``area_mode``), f32
    only."""
    scale = 1.0 / (dst / src)
    d = np.arange(dst, dtype=np.float64)
    if area:
        s = np.floor(d * scale)
        f = ((d + 1) - (s + 1) * (dst / src)).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f))
        s = s.astype(np.int64)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(dtype)
        s = np.floor(f).astype(np.int64)
        f = f - s.astype(dtype)
    if clamp_weight:                 # along x: a border tap takes weight 1
        f[(s < 0) | (s >= src - 1)] = 0
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            dtype(1) - f, f)


def _integer_scales(src_hw, dst_hw):
    """OpenCV's ``is_area_fast``: the integer scale of each axis when
    both scales are integers (within DBL_EPSILON), else None."""
    eps = sys.float_info.epsilon
    out = []
    for src, dst in zip(src_hw, dst_hw):
        scale = 1.0 / (dst / src)
        if abs(scale - round(scale)) >= eps:
            return None
        out.append(round(scale))
    return tuple(out)


def _exact_2x(src_hw, dst_hw) -> bool:
    """OpenCV's ``is_area_fast`` with both integer scales equal to 2."""
    return _integer_scales(src_hw, dst_hw) == (2, 2)


def _mean_2x2_u8(x: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """``(a + b + c + d + 2) >> 2`` over each 2x2 block of uint8 (H, W,
    C)."""
    q = x[:2 * dh, :2 * dw].to(torch.int32)
    s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
    return ((s + 2) >> 2).to(torch.uint8)


def _fixed(w: np.ndarray) -> np.ndarray:
    """f32 weights -> OpenCV's 11-bit fixed point (cvRound: half to
    even)."""
    return np.rint(w * np.float32(COEF_SCALE)).astype(np.int32)


def resize(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize)`` with INTER_LINEAR, dsize = (width,
    height). img: (H, W) or (H, W, C), uint8, float32 or float64, on any
    device. Returns a new tensor of img's dtype on img's device."""
    if img.dtype not in (torch.uint8, torch.float32, torch.float64):
        raise TypeError(f"resize takes uint8, f32 or f64, not {img.dtype}")
    if img.dim() not in (2, 3):
        raise ValueError(f"want (H, W) or (H, W, C), got {tuple(img.shape)}")
    dw, dh = (int(v) for v in dsize)
    sh, sw = img.shape[:2]
    if dw <= 0 or dh <= 0 or sh <= 0 or sw <= 0:
        raise ValueError(f"cannot resize {tuple(img.shape)} to {dsize}")
    x = img if img.dim() == 3 else img[..., None]
    dev = img.device
    if _exact_2x((sh, sw), (dh, dw)):
        if img.dtype == torch.uint8:
            out = _mean_2x2_u8(x, dh, dw)
        else:
            q = x[:2 * dh, :2 * dw]
            s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
            out = s * 0.25
        return out if img.dim() == 3 else out[..., 0]

    wdt = np.float32 if img.dtype == torch.uint8 else np.float64
    yax = _axis(sh, dh, clamp_weight=False, dtype=wdt)
    xax = _axis(sw, dw, clamp_weight=True, dtype=wdt)
    if img.dtype == torch.uint8:
        out = _linear_u8(x, yax, xax)
    else:
        ys0, ys1, by0, by1 = yax
        xs0, xs1, ax0, ax1 = xax
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        rows, pos = _rows_read(ys0, ys1)
        src = x[t(rows)].double()
        i0, i1 = t(xs0), t(xs1)
        hsum = src[:, i0] * t(ax0)[:, None] + src[:, i1] * t(ax1)[:, None]
        out = (hsum[t(pos[0])] * t(by0)[:, None, None]
               + hsum[t(pos[1])] * t(by1)[:, None, None]).to(img.dtype)
    return out if img.dim() == 3 else out[..., 0]


def _rows_read(ys0, ys1):
    """The source rows the vertical pass reads, and where each tap's row
    lies among them (the horizontal pass runs on those rows only)."""
    rows = np.unique(np.concatenate([ys0, ys1]))
    return rows, np.searchsorted(rows, np.stack([ys0, ys1]))


def _linear_u8(x: torch.Tensor, yax, xax) -> torch.Tensor:
    """OpenCV's fixed-point two-tap route on uint8 (H, W, C), given each
    axis's taps and f32 weights from ``_axis``."""
    ys0, ys1, by0, by1 = yax
    xs0, xs1, ax0, ax1 = xax
    t = lambda a: torch.from_numpy(a).to(x.device)  # noqa: E731
    rows, pos = _rows_read(ys0, ys1)
    src = x[t(rows)].to(torch.int32)
    a0, a1 = t(_fixed(ax0))[:, None], t(_fixed(ax1))[:, None]
    hsum = src[:, t(xs0)] * a0 + src[:, t(xs1)] * a1  # (rows, dw, C) int32
    hsum = hsum >> 4
    b0 = t(_fixed(by0))[:, None, None]
    b1 = t(_fixed(by1))[:, None, None]
    out = ((hsum[t(pos[0])] * b0) >> 16) + ((hsum[t(pos[1])] * b1) >> 16)
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def _area_tab(src: int, dst: int):
    """OpenCV's ``computeResizeAreaTab`` as (dst, T) arrays: the source
    index and f32 alpha of each destination's taps in table order,
    padded with alpha 0 at index 0 (adding 0 * S leaves a sum as it
    is)."""
    scale = 1.0 / (dst / src)
    taps = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx2 = min(math.floor(fsx2), src - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row.extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    width = max(len(r) for r in taps)
    idx = np.zeros((dst, width), np.int64)
    alpha = np.zeros((dst, width), np.float32)
    for dx, row in enumerate(taps):
        for k, (sx, a) in enumerate(row):
            idx[dx, k], alpha[dx, k] = sx, a
    return idx, alpha


def resize_area(img: torch.Tensor, dsize: Tuple[int, int]) -> torch.Tensor:
    """``cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)``, dsize =
    (width, height). img: uint8 (H, W) or (H, W, C), on any device.
    Returns a new uint8 tensor on img's device."""
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_area takes uint8, not {img.dtype}")
    if img.dim() not in (2, 3):
        raise ValueError(f"want (H, W) or (H, W, C), got {tuple(img.shape)}")
    dw, dh = (int(v) for v in dsize)
    sh, sw = img.shape[:2]
    if dw <= 0 or dh <= 0 or sh <= 0 or sw <= 0:
        raise ValueError(f"cannot resize {tuple(img.shape)} to {dsize}")
    x = img if img.dim() == 3 else img[..., None]
    t = lambda a: torch.from_numpy(a).to(img.device)  # noqa: E731
    if (dh, dw) == (sh, sw):
        out = x.clone()
    elif dh > sh or dw > sw:             # an upscaled axis: linear route
        out = _linear_u8(
            x, _axis(sh, dh, clamp_weight=False, area=True),
            _axis(sw, dw, clamp_weight=True, area=True))
    elif (k := _integer_scales((sh, sw), (dh, dw))) is not None:
        if k == (2, 2) and x.shape[2] in (1, 3, 4):
            out = _mean_2x2_u8(x, dh, dw)
        else:
            ky, kx = k
            s = x[:ky * dh, :kx * dw].to(torch.int32).reshape(
                dh, ky, dw, kx, -1).sum((1, 3))
            out = torch.round(s.float() * np.float32(1.0 / (ky * kx)))
            out = out.clamp_(0, 255).to(torch.uint8)
    else:
        xi, xa = _area_tab(sw, dw)
        yi, ya = _area_tab(sh, dh)
        src = x.float()
        buf = torch.zeros((sh, dw, x.shape[2]), dtype=torch.float32,
                          device=img.device)
        for k in range(xi.shape[1]):     # buf += S * alpha, in table order
            buf = buf + src[:, t(xi[:, k])] * t(xa[:, k])[:, None]
        out = None
        for k in range(yi.shape[1]):     # sum = beta * buf, then += ...
            term = buf[t(yi[:, k])] * t(ya[:, k])[:, None, None]
            out = term if out is None else out + term
        out = torch.round(out).clamp_(0, 255).to(torch.uint8)
    return out if img.dim() == 3 else out[..., 0]
