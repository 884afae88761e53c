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
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

COEF_BITS = 11                       # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _axis(src: int, dst: int, *, clamp_weight: bool, dtype=np.float32):
    """(index of the first tap, index of the second, weight of the first,
    weight of the second) for each of ``dst`` outputs along an axis of
    ``src`` pixels. dtype f32 rounds the coordinate and the weights to f32,
    as OpenCV's fixed-point route does (``cbuf``); f64 keeps them in
    double."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(dtype)
    if clamp_weight:                 # along x: a border tap takes weight 1
        f[(s < 0) | (s >= src - 1)] = 0
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            dtype(1) - f, f)


def _exact_2x(src_hw, dst_hw) -> bool:
    """OpenCV's ``is_area_fast`` with both integer scales equal to 2."""
    eps = sys.float_info.epsilon
    for src, dst in zip(src_hw, dst_hw):
        scale = 1.0 / (dst / src)
        if abs(scale - round(scale)) >= eps or round(scale) != 2:
            return False
    return True


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
            q = x[:2 * dh, :2 * dw].to(torch.int32)
            s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
            out = ((s + 2) >> 2).to(torch.uint8)
        else:
            q = x[:2 * dh, :2 * dw]
            s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
            out = s * 0.25
        return out if img.dim() == 3 else out[..., 0]

    wdt = np.float32 if img.dtype == torch.uint8 else np.float64
    ys0, ys1, by0, by1 = _axis(sh, dh, clamp_weight=False, dtype=wdt)
    xs0, xs1, ax0, ax1 = _axis(sw, dw, clamp_weight=True, dtype=wdt)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    # the horizontal pass on the rows the vertical pass reads
    rows = np.unique(np.concatenate([ys0, ys1]))
    pos = np.searchsorted(rows, np.stack([ys0, ys1]))
    src = x[t(rows)]
    i0, i1 = t(xs0), t(xs1)
    if img.dtype == torch.uint8:
        src = src.to(torch.int32)
        a0, a1 = t(_fixed(ax0))[:, None], t(_fixed(ax1))[:, None]
        hsum = src[:, i0] * a0 + src[:, i1] * a1      # (rows, dw, C) int32
        hsum = hsum >> 4
        b0 = t(_fixed(by0))[:, None, None]
        b1 = t(_fixed(by1))[:, None, None]
        out = ((hsum[t(pos[0])] * b0) >> 16) + ((hsum[t(pos[1])] * b1) >> 16)
        out = ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)
    else:
        src = src.double()
        hsum = src[:, i0] * t(ax0)[:, None] + src[:, i1] * t(ax1)[:, None]
        out = (hsum[t(pos[0])] * t(by0)[:, None, None]
               + hsum[t(pos[1])] * t(by1)[:, None, None]).to(img.dtype)
    return out if img.dim() == 3 else out[..., 0]
