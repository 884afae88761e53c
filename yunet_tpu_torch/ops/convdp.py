"""Fused ConvDPUnit (1x1 pointwise -> 3x3 depthwise -> ReLU) — counterpart
of ``yunet_tpu/ops/convdp_pallas.py:fused_conv_dp``.

``fused_conv_dp`` keeps the JAX contract: NHWC in and out, stride 1, SAME
3x3 depthwise, BN already folded into (wd, bd); w1 as (1, 1, Cin, Cout) or
(Cin, Cout) and wd as (3, 3, 1, Cout) or (9, Cout). The pointwise result
y1 and the accumulator are f32; the output is x's dtype (f32 or bf16).

A CUDA tensor goes to the hand-written kernel (``csrc/convdp.cu``); a CPU
tensor goes to ``fused_conv_dp_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCE = os.path.join(CSRC_DIR, "convdp.cu")
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS,
    {**cuda_signatures(yunet_convdp_forward=[_P] * 6 + [_I] * 7 + [_P]),
     "yunet_convdp_smem_bytes": (ctypes.c_size_t, [_I, _I])})
MAX_SMEM = 227 * 1024  # a block's dynamic shared memory limit on Hopper


def _weights(w1, b1, wd, bd):
    cout = w1.shape[-1]
    w1 = w1.reshape(-1, cout)
    if wd.numel() != 9 * cout or b1.shape != (cout,) or bd.shape != (cout,):
        raise ValueError(
            f"ConvDP weight shapes disagree: w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)}, wd {tuple(wd.shape)}, bd {tuple(bd.shape)}")
    return w1, b1, wd.reshape(9, cout), bd


def fused_conv_dp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        wd: torch.Tensor, bd: torch.Tensor, *,
                        relu: bool = True) -> torch.Tensor:
    """The plain version: F.conv2d 1x1, then the depthwise conv with
    groups=Cout, in f32, cast to x's dtype at the end."""
    w1, b1, wd, bd = _weights(w1, b1, wd, bd)
    cin, cout = w1.shape
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w1.float().t().reshape(cout, cin, 1, 1), b1.float())
    y = F.conv2d(y, wd.float().t().reshape(cout, 1, 3, 3), bd.float(),
                 padding=1, groups=cout)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def fused_conv_dp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  wd: torch.Tensor, bd: torch.Tensor, *,
                  relu: bool = True) -> torch.Tensor:
    """x: (N, H, W, Cin) -> (N, H, W, Cout) in x's dtype."""
    if x.dim() != 4 or x.shape[-1] != w1.reshape(-1, w1.shape[-1]).shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match w1 "
                         f"{tuple(w1.shape)}")
    if x.device.type == "cpu":
        return fused_conv_dp_plain(x, w1, b1, wd, bd, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_dp: no kernel for {x.device}")
    w1, b1, wd, bd = _weights(w1, b1, wd, bd)
    n, h, w, cin = x.shape
    cout = w1.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_conv_dp: x must be f32 or bf16, not "
                        f"{x.dtype}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("wd", wd),
                    ("bd", bd)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_conv_dp: {name} must be contiguous on "
                             f"{x.device}")
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"fused_conv_dp: {name} must be f32")
    if n > 65535:
        raise ValueError("fused_conv_dp: batch above the grid limit 65535")
    lib = LIB.get()
    if lib.yunet_convdp_smem_bytes(cin, cout) > MAX_SMEM:
        raise ValueError(f"fused_conv_dp: {cin}->{cout} channels need more "
                         "shared memory than a block has")
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        with torch.cuda.device(x.device):
            code = lib.yunet_convdp_forward(
                x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wd.data_ptr(),
                bd.data_ptr(), out.data_ptr(), n, h, w, cin, cout, int(relu),
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        check_cuda_status(lib, code, "fused_conv_dp")
        fused_conv_dp.launches += 1
    return out


fused_conv_dp.launches = 0
