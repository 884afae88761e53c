"""OpenCV's uint8 colour conversions as torch integer and float32 ops (any
device), without OpenCV; byte-equal to OpenCV 5.0 on every input:

  bgr_to_hsv  cv2.cvtColor(img, cv2.COLOR_BGR2HSV)   (H in [0, 180))
  hsv_to_bgr  cv2.cvtColor(img, cv2.COLOR_HSV2BGR)
  bgr_to_gray cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)

BGR->HSV is OpenCV's fixed point: V = max, S = round(diff * 255 / V) and
H = round(h6 * 180 / (6 * diff)) through tables of 2^12-scaled
reciprocals rounded to integers. HSV->BGR is its float path: S and V
scaled by 1/255, the hue sector and fraction in float32, the four sector
values v, v*(1 - s), v*fma(-s, f, 1) and v*fma(-s, 1 - f, 1), then
value * 255 made an integer: truncated in OpenCV's vector loop, which
covers a row's pixels in steps of 32, rounded half to even in its scalar
loop over the last width % 32 pixels of the row (a row is dim -2 of an
(H, W, 3) image). BGR->GRAY weighs the channels by 15-bit fixed-point
weights and rounds.
"""

from __future__ import annotations

import numpy as np
import torch

_HSV_SHIFT = 12
_GRAY_SHIFT = 15
# 0.114, 0.587 and 0.299 scaled by 2^15 and rounded (B, G, R)
_GRAY_WEIGHTS = (3735, 19235, 9798)
# pixels a step of OpenCV's HSV->BGR vector loop covers
_HSV_LANES = 32


def _tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << _HSV_SHIFT) / i), 0)
        hdiv = np.where(i > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * i)), 0)
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


_SDIV, _HDIV = _tables()


def _check_u8(img: torch.Tensor) -> None:
    if img.dtype != torch.uint8 or img.dim() < 1 or img.shape[-1] != 3:
        raise TypeError("want a uint8 tensor of 3-channel pixels (..., 3), "
                        f"got {img.dtype} {tuple(img.shape)}")


def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR -> (..., 3) uint8 HSV, H in [0, 180)."""
    _check_u8(img)
    x = img.int()
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    sdiv = torch.from_numpy(_SDIV).to(img.device)
    hdiv = torch.from_numpy(_HDIV).to(img.device)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v.long()] + half) >> _HSV_SHIFT
    # the hue's sextant numerator: R is the max first, then G
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff.long()] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding of the float64 result."""
    return (a.double() * b.double() + c).float()


def hsv_to_bgr(img: torch.Tensor) -> torch.Tensor:
    """(..., W, 3) uint8 HSV (H in [0, 180)) -> (..., W, 3) uint8 BGR."""
    _check_u8(img)
    if img.dim() < 2:
        raise TypeError(f"want rows of pixels (..., W, 3), got "
                        f"{tuple(img.shape)}")
    x = img.float()
    scale = torch.tensor(1.0 / 255.0, dtype=torch.float32)
    h = x[..., 0] * torch.tensor(6.0 / 180.0, dtype=torch.float32)
    s = x[..., 1] * scale
    v = x[..., 2] * scale
    sector = torch.floor(h)
    f = h - sector
    one = torch.ones((), dtype=torch.float32)
    tab = torch.stack([v, v * (one - s), v * _fma(-s, f, 1.0),
                       v * _fma(-s, one - f, 1.0)], dim=-1)
    sector = sector.long() % 6
    # (B, G, R) <- tab indices per sector
    order = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                          [0, 2, 1], [0, 1, 3], [2, 1, 0]],
                         device=img.device)
    bgr = torch.gather(tab, -1, order[sector]) \
        * torch.tensor(255.0, dtype=torch.float32)
    w = img.shape[-2]
    col = torch.arange(w, device=img.device)[:, None]
    out = torch.where(col >= w - w % _HSV_LANES, torch.round(bgr),
                      torch.trunc(bgr))
    return out.clamp(0, 255).to(torch.uint8)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR -> (...) uint8 grey."""
    _check_u8(img)
    x = img.int()
    wb, wg, wr = _GRAY_WEIGHTS
    y = x[..., 0] * wb + x[..., 1] * wg + x[..., 2] * wr
    return ((y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).to(torch.uint8)
