"""``cv2.warpPerspective`` for float32 images with INTER_LINEAR and a
constant border, as torch ops (any device), without OpenCV.

The arithmetic is OpenCV 5.0's float path for 32-bit images, step by
step in float32: the matrix is inverted in float64 and rounded to float32;
in the vector loop each row's term ``y*M[1] + M[2]`` is a product and a
sum and the column term is fused into it, ``fma(x, M[0], row)``, while
the scalar loop over the last ``width % 16`` columns computes
``fma(x, M[0], y*M[1]) + M[2]`` (numerator and denominator alike); the
source coordinate is a true division; the four taps
are blended as two fused lerps along x and one along y. The source
coordinate is not rounded to a fraction of a pixel. A tap outside the
image reads the border value.

The fused multiply-adds are emulated in float64 (the product of two
float32 values is exact there) and rounded once to float32, so a result
may differ from a true fused multiply-add where the float64 sum falls on
a float32 rounding midpoint.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# output columns a step of OpenCV's vector loop covers; the last
# width % _LANES columns of a row take its scalar remainder loop, whose
# compiled arithmetic orders the coordinate's sum differently
_LANES = 16


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 with one rounding of the float64 result."""
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    return (a.double() * b + c.double()).float()


def warp_perspective(img: torch.Tensor, m: np.ndarray,
                     dsize: Tuple[int, int],
                     border_value: Sequence[float] = (0.0, 0.0, 0.0)
                     ) -> torch.Tensor:
    """``cv2.warpPerspective(img, m, dsize, borderValue=border_value)``:
    img (H, W, C) float32, m (3, 3) the forward map (source -> output),
    dsize = (width, height). Returns (height, width, C) float32 on img's
    device."""
    if img.dtype != torch.float32:
        raise TypeError(f"warp_perspective takes float32, not {img.dtype}")
    if img.dim() != 3:
        raise ValueError(f"want (H, W, C), got {tuple(img.shape)}")
    h, w, c = img.shape
    ow, oh = (int(v) for v in dsize)
    dev = img.device
    minv = np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)
    mv = [float(v) for v in minv.reshape(-1)]

    x = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]

    def coord(i):
        a, b, c = (torch.tensor(v, device=dev) for v in mv[3 * i:3 * i + 3])
        xs, yb = x.expand(oh, ow), (y * b).expand(oh, ow)
        body = _fma(xs, a, yb + c)        # the vector loop's order
        tail = _fma(xs, a, yb) + c        # the scalar remainder's order
        return torch.where(x >= ow - ow % _LANES, tail, body)

    wz = coord(2)
    sx = coord(0) / wz
    sy = coord(1) / wz
    finite = torch.isfinite(sx) & torch.isfinite(sy) & (sx.abs() < 2 ** 30) \
        & (sy.abs() < 2 ** 30)
    sx = torch.where(finite, sx, torch.full_like(sx, -4.0))
    sy = torch.where(finite, sy, torch.full_like(sy, -4.0))
    fx0, fy0 = torch.floor(sx), torch.floor(sy)
    fx = (sx - fx0)[..., None].expand(oh, ow, c)
    fy = (sy - fy0)[..., None].expand(oh, ow, c)
    ix, iy = fx0.long(), fy0.long()

    flat = img.reshape(-1, c)
    border = torch.tensor([float(v) for v in border_value][:c],
                          dtype=torch.float32, device=dev)
    if border.numel() < c:
        border = torch.cat([border, border.new_zeros(c - border.numel())])

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)]
        return torch.where(ok.reshape(-1, 1), v, border).reshape(oh, ow, c)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma(fx, p01 - p00, p00)
    v1 = _fma(fx, p11 - p10, p10)
    return _fma(fy, v1 - v0, v0)
