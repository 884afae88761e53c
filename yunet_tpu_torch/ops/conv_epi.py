"""A conv whose epilogue adds the bias, an optional shortcut and an
optional ReLU: SCRFD's folded convs (``models/scrfd.py:scrfd_conv``).

``conv_epi(x, w, wp, b, stride=, relu=, residual=None, upsample=1)``
takes x as (N, Cin, H, W) in channels-last memory, w OIHW, its packed form
wp (``pack_weights``) and the bias b in f32, and returns
``[relu](conv2d(x, w, b, stride, padding=k // 2) + up(residual))`` as
(N, Cout, Ho, Wo) channels-last in x's dtype, where ``up`` repeats each
pixel of a residual of (Ho / upsample, Wo / upsample) upsample x upsample
times (``F.interpolate``'s nearest mode at an integer scale).

A CUDA tensor goes to the hand-written kernel of ``csrc/scrfd_conv.cu``
(bf16 only: an implicit-GEMM conv on the tensor cores from a staged input
halo, f32 sums, the epilogue before one rounding to bf16; its block tile
from ``tiles``); anything else on CUDA raises. A CPU tensor goes to
``conv_epi_plain``, the same function in plain PyTorch in x's dtype (each
of the conv, the shortcut add and the ReLU rounded to it, as the library
route on the card rounds).

The kernel counts its launches in ``conv_epi.launches``, and those with a
shortcut and with a ReLU in ``.launches_residual`` and ``.launches_relu``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCE = os.path.join(CSRC_DIR, "scrfd_conv.cu")
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS,
    cuda_signatures(yunet_scrfd_conv_forward=[_P] * 5 + [_I] * 16 + [_P]))

SMS = 132                                  # an H100 SXM's multiprocessors
TILE_N = (1, 3, 4, 7, 10, 11, 14)          # n8 tiles a block, as built
BIG_MAP = 320 * 320     # output pixels from which a block takes all of Cout


def padded_channels(cin: int) -> int:
    """Each tap's channels in the packed weights: Cin rounded up to 8."""
    return -(-cin // 8) * 8


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights -> (Cout, k * k * cp) bf16, K-major rows an output
    channel: tap by tap (row-major over the kernel window), each tap's
    Cin channels zero-padded to cp = ``padded_channels(Cin)``."""
    cout, cin, kh, kw = w.shape
    taps = w.permute(0, 2, 3, 1).float()             # (O, kh, kw, I)
    taps = F.pad(taps, (0, padded_channels(cin) - cin))
    return taps.reshape(cout, -1).to(torch.bfloat16).contiguous()


def unpack_weights(wp: torch.Tensor, cin: int, k: int) -> torch.Tensor:
    """``pack_weights``' inverse: (Cout, k * k * cp) -> OIHW f32."""
    taps = wp.float().reshape(wp.shape[0], k, k, padded_channels(cin))
    return taps[..., :cin].permute(0, 3, 1, 2).contiguous()


def _out_hw(x: torch.Tensor, w: torch.Tensor, stride: int
            ) -> Tuple[int, int]:
    k = w.shape[-1]
    return tuple((s + 2 * (k // 2) - k) // stride + 1 for s in x.shape[2:])


def _check(x, w, b, stride, residual, upsample):
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[1] \
            or w.shape[2] != w.shape[3] or w.shape[2] % 2 == 0:
        raise ValueError(f"conv_epi: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (N, Cin, H, W) and an "
                         "odd square OIHW kernel")
    if b.shape != (w.shape[0],):
        raise ValueError(f"conv_epi: bias {tuple(b.shape)} for "
                         f"{w.shape[0]} channels")
    if residual is not None:
        ho, wo = _out_hw(x, w, stride)
        want = (x.shape[0], w.shape[0], ho // upsample, wo // upsample)
        if ho % upsample or wo % upsample or tuple(residual.shape) != want:
            raise ValueError(f"conv_epi: residual {tuple(residual.shape)} "
                             f"is not {want} upsampled {upsample}x to the "
                             f"output's ({ho}, {wo})")


def conv_epi_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                   stride: int, relu: bool,
                   residual: Optional[torch.Tensor] = None,
                   upsample: int = 1) -> torch.Tensor:
    """The plain version: ``F.conv2d`` with w and b in x's dtype, + the
    residual (nearest-upsampled to the output's size), then ReLU."""
    _check(x, w, b, stride, residual, upsample)
    y = F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride, w.shape[-1] // 2)
    if residual is not None:
        y.add_(residual if upsample == 1 else F.interpolate(
            residual, size=y.shape[2:], mode="nearest"))
    return y.relu_() if relu else y


@functools.lru_cache(maxsize=None)
def tiles(n: int, ho: int, wo: int, cin: int, cout: int, k: int
          ) -> Tuple[int, int, int, int, int]:
    """(nt, wm, wk, tw, kc) of the kernel's block for a conv of n images
    to ho x wo outputs, cin -> cout channels, k x k: 8 * nt output
    channels (all of Cout up to 112 on a map of BIG_MAP pixels or more;
    elsewhere 32 where Cout has more, in as many block columns as it
    takes), an output tile of 32 * wm pixels tw wide (8 up to 80 columns,
    16 above), the largest that still gives about one block an SM, 8
    warps (wm x wk, wk splitting the taps), and input channel chunks of kc
    (64 for 33 to 64 channels). Chosen by a sweep of every tile over
    SCRFD-10GF-KPS's convs at 640x640 on an H100."""
    cp = padded_channels(cin)
    kc = 16 if cp <= 16 else 64 if 32 < cp <= 64 else 32
    tw = 8 if wo <= 80 else 16
    need = -(-cout // 8)
    if ho * wo >= BIG_MAP and need <= TILE_N[-1]:
        nt = next(t for t in TILE_N if t >= need)
    else:
        nt = 1 if cout <= 8 else 3 if cout <= 24 else 4
    cols = -(-cout // (8 * nt))
    for wm in (8, 4, 2, 1):
        tiles_ = -(-ho // (32 * wm // tw)) * -(-wo // tw)
        if 32 * wm >= tw and n * tiles_ * cols >= 3 * SMS // 4:
            break
    return nt, wm, 8 // wm, tw, kc


def conv_epi(x: torch.Tensor, w: torch.Tensor, wp: torch.Tensor,
             b: torch.Tensor, *, stride: int, relu: bool,
             residual: Optional[torch.Tensor] = None,
             upsample: int = 1) -> torch.Tensor:
    """x: (N, Cin, H, W) channels-last -> (N, Cout, Ho, Wo) channels-last
    in x's dtype."""
    if x.device.type == "cpu":
        return conv_epi_plain(x, w, b, stride=stride, relu=relu,
                              residual=residual, upsample=upsample)
    if x.device.type != "cuda":
        raise ValueError(f"conv_epi: no kernel for {x.device}")
    _check(x, w, b, stride, residual, upsample)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"conv_epi: x must be bf16, not {x.dtype}")
    n, cin, h, wd = x.shape
    cout, k = w.shape[0], w.shape[-1]
    kdim = k * k * padded_channels(cin)
    cl = torch.channels_last
    checks = [("x", x, torch.bfloat16, x.is_contiguous(memory_format=cl)),
              ("wp", wp, torch.bfloat16, wp.is_contiguous()
               and tuple(wp.shape) == (cout, kdim)),
              ("b", b, torch.float32, b.is_contiguous())]
    if residual is not None:
        checks.append(("residual", residual, torch.bfloat16,
                       residual.is_contiguous(memory_format=cl)))
    for name, t, dt, ok in checks:
        if t.device != x.device or t.dtype != dt or not ok \
                or t.data_ptr() % 16:
            raise ValueError(f"conv_epi: {name} must be {dt}, contiguous "
                             f"(x and residual channels-last; wp "
                             f"({cout}, {kdim})) and 16-byte aligned on "
                             f"{x.device}")
    ho, wo = _out_hw(x, w, stride)
    out = torch.empty((n, cout, ho, wo), dtype=x.dtype, device=x.device,
                      memory_format=cl)
    if out.numel():
        tile = tiles(n, ho, wo, cin, cout, k)
        lib = LIB.get()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.yunet_scrfd_conv_forward(
                x.data_ptr(), wp.data_ptr(), b.data_ptr(),
                None if residual is None else residual.data_ptr(),
                out.data_ptr(), n, h, wd, cin, k, stride, ho, wo, cout,
                upsample, int(relu), *tile, stream)
        check_cuda_status(lib, code, "conv_epi")
        conv_epi.launches += 1
        conv_epi.launches_residual += int(residual is not None)
        conv_epi.launches_relu += int(relu)
    return out


# every launch, and those with a shortcut and with a ReLU
conv_epi.launches = 0
conv_epi.launches_residual = 0
conv_epi.launches_relu = 0
