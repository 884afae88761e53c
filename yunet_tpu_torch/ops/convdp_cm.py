"""Fused ConvDPUnit in the channels-major layout — counterpart of
``yunet_tpu/ops/convdp_cm_pallas.py:fused_conv_dp_cm_impl``.

``fused_conv_dp_cm(x, w1, b1, wd, bd, *, w, n, relu=False)`` takes x as
(H, Cin, W*N), the batch N minor in the W*N flattening, and returns
(H, Cout, W*N) in x's dtype. Weights as in ``ops/convdp.py``: w1 (Cin,
Cout) or (1, 1, Cin, Cout), b1 (Cout,), wd (9, Cout) or (3, 3, 1, Cout),
bd (Cout,), f32. Numerics: y1 = (w1 in x's dtype) . x + b1, summed in f32
and rounded to x's dtype, zero outside the image; then the 9-tap stencil
in f32, + bd, optional ReLU, rounded once. The JAX function's
``n % 128 == 0`` (a TPU lane rule) and its block sizes are not part of
this contract: any N is taken.

A CUDA tensor goes to the hand-written kernel (``csrc/convdp_cm.cu``); a
CPU tensor goes to ``fused_conv_dp_cm_plain``. Only the bench twin
(``tools/bench_convdp_cm.py``) runs it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)
from .convdp import MAX_SMEM, _weights

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCE = os.path.join(CSRC_DIR, "convdp_cm.cu")
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS,
    {**cuda_signatures(yunet_convdp_cm_forward=[_P] * 6 + [_I] * 7 + [_P]),
     "yunet_convdp_cm_smem_bytes": (ctypes.c_size_t, [_I, _I])})


def _check(x, w1, w, n):
    cin = w1.reshape(-1, w1.shape[-1]).shape[0]
    if x.dim() != 3 or x.shape[1] != cin or x.shape[2] != w * n:
        raise ValueError(f"fused_conv_dp_cm: x {tuple(x.shape)} is not "
                         f"(H, {cin}, {w}*{n})")


def fused_conv_dp_cm_plain(x: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, wd: torch.Tensor,
                           bd: torch.Tensor, *, w: int, n: int,
                           relu: bool = False) -> torch.Tensor:
    """The plain version, on an NHWC view: y1 with w1 in x's dtype,
    rounded to it; the stencil in f32 in tap order."""
    _check(x, w1, w, n)
    w1, b1, wd, bd = _weights(w1, b1, wd, bd)
    h, cin = x.shape[:2]
    cout = w1.shape[1]
    xn = x.reshape(h, cin, w, n).permute(3, 0, 2, 1).float()  # (N, H, W, C)
    y1 = (xn @ w1.to(x.dtype).float() + b1.float()).to(x.dtype).float()
    y1 = F.pad(y1, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, w, cout), dtype=torch.float32, device=x.device)
    for t in range(9):
        ty, tx = divmod(t, 3)
        acc = acc + y1[:, ty:ty + h, tx:tx + w] * wd[t].float()
    acc = acc + bd.float()
    if relu:
        acc = F.relu(acc)
    return acc.to(x.dtype).permute(1, 3, 2, 0).reshape(h, cout, w * n)


def fused_conv_dp_cm(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     wd: torch.Tensor, bd: torch.Tensor, *, w: int, n: int,
                     relu: bool = False) -> torch.Tensor:
    """x: (H, Cin, W*N) -> (H, Cout, W*N) in x's dtype."""
    _check(x, w1, w, n)
    if x.device.type == "cpu":
        return fused_conv_dp_cm_plain(x, w1, b1, wd, bd, w=w, n=n,
                                      relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_dp_cm: no kernel for {x.device}")
    w1, b1, wd, bd = _weights(w1, b1, wd, bd)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_conv_dp_cm: x must be f32 or bf16, not "
                        f"{x.dtype}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("wd", wd),
                    ("bd", bd)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_conv_dp_cm: {name} must be contiguous "
                             f"on {x.device}")
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"fused_conv_dp_cm: {name} must be f32")
    h, cin = x.shape[:2]
    cout = w1.shape[1]
    if -(-n // 32) > 65535 or -(-h // 32) > 65535:
        raise ValueError("fused_conv_dp_cm: batch or height above the grid "
                         "limit")
    lib = LIB.get()
    if lib.yunet_convdp_cm_smem_bytes(cin, cout) > MAX_SMEM:
        raise ValueError(f"fused_conv_dp_cm: {cin}->{cout} channels need "
                         "more shared memory than a block has")
    out = torch.empty((h, cout, w * n), dtype=x.dtype, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            code = lib.yunet_convdp_cm_forward(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wd.data_ptr(),
                bd.data_ptr(), out.data_ptr(), h, w, n, cin, cout, int(relu),
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        check_cuda_status(lib, code, "fused_conv_dp_cm")
        fused_conv_dp_cm.launches += 1
    return out


fused_conv_dp_cm.launches = 0
