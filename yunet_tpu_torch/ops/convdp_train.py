"""Trainable fused ConvDPUnit, z = dw3x3(pw1x1(x) + b1) + bd — counterpart of
``yunet_tpu/ops/convdp_train_pallas.py:fused_pw_dw``.

``fused_pw_dw`` is a ``torch.autograd.Function`` on NHWC tensors. Its
forward is the inference kernel without ReLU
(``ops/convdp.py:fused_conv_dp``): y1 stays f32, with f32 weights. Its
backward, ``fused_pw_dw_bwd``, recomputes y1 from x instead of storing it
and returns (dx, dw1, db1, dwd, dbd):

  dy1 = corr(dz, rot180 wd)      dx  = dy1 . w1^T
  dw1 = x^T . dy1                db1 = sum dy1
  dwd[t] = sum y1_shift_t * dz   dbd = sum dz

with the numerics of ``yunet_tpu/ops/convdp_pallas_impl.py:bwd_kernel``:
the recompute casts w1 to x's dtype and rounds y1 to it (bf16 in the
shipped config), y1 is zero outside the image, dx takes the f32 w1 and is
rounded once to x's dtype, and the parameter gradients are f32 sums over
every position. The JAX ``row_block`` only tiles the TPU grid; there is
no such argument here.

A CUDA tensor goes to the hand-written kernel (``csrc/convdp_bwd.cu``),
by its dtype: bf16 (the shipped dtype) to the tensor-core route, at most
64 channels each side, f32 to the scalar route. A CPU tensor goes to
``fused_pw_dw_bwd_plain``, the same function in f32 PyTorch ops.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)
from .convdp import MAX_SMEM, fused_conv_dp

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCE = os.path.join(CSRC_DIR, "convdp_bwd.cu")
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS,
    {**cuda_signatures(yunet_convdp_backward=[_P] * 8 + [_I] * 6 + [_P]),
     "yunet_convdp_bwd_smem_bytes": (ctypes.c_size_t, [_I, _I]),
     "yunet_convdp_bwd_mma_max_channels": (_I, []),
     "yunet_convdp_bwd_blocks": (_I, [_I, _I, _I]),
     "yunet_convdp_bwd_acc_len": (_I, [_I, _I])})


def _check(x, w1, b1, wd, dz):
    cout = w1.shape[-1]
    cin = w1.numel() // cout
    if (x.dim() != 4 or x.shape[-1] != cin or dz.shape != (*x.shape[:3], cout)
            or b1.shape != (cout,) or wd.numel() != 9 * cout):
        raise ValueError(
            f"fused_pw_dw_bwd: shapes disagree: x {tuple(x.shape)}, dz "
            f"{tuple(dz.shape)}, w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, "
            f"wd {tuple(wd.shape)}")
    return cin, cout


def fused_pw_dw_bwd_plain(x: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, wd: torch.Tensor,
                          dz: torch.Tensor):
    """The plain version in f32 torch ops. Returns (dx in x's dtype, dw1
    (Cin, Cout), db1 (Cout,), dwd (9, Cout), dbd (Cout,)), all f32 but
    dx."""
    cin, cout = _check(x, w1, b1, wd, dz)
    n, h, w, _ = x.shape
    xf, dzf = x.float(), dz.float()
    w1 = w1.reshape(cin, cout).float()
    wd = wd.reshape(9, cout).float()
    # the recompute: w1 in x's dtype, y1 rounded to it; zero padding
    y1 = (xf.reshape(-1, cin) @ w1.to(x.dtype).float() + b1.float())
    y1 = y1.to(x.dtype).float().reshape(n, h, w, cout)
    pad = (0, 0, 1, 1, 1, 1)
    y1p, dzp = F.pad(y1, pad), F.pad(dzf, pad)
    dy1 = torch.zeros_like(dzf)
    dwd = []
    for t in range(9):
        ty, tx = divmod(t, 3)
        dy1 = dy1 + dzp[:, 2 - ty:2 - ty + h, 2 - tx:2 - tx + w] * wd[t]
        dwd.append((y1p[:, ty:ty + h, tx:tx + w] * dzf).sum((0, 1, 2)))
    dy1_2d = dy1.reshape(-1, cout)
    dx = (dy1_2d @ w1.t()).reshape(n, h, w, cin).to(x.dtype)
    return (dx, xf.reshape(-1, cin).t() @ dy1_2d, dy1_2d.sum(0),
            torch.stack(dwd), dzf.sum((0, 1, 2)))


def fused_pw_dw_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    wd: torch.Tensor, dz: torch.Tensor):
    """(dx, dw1, db1, dwd, dbd) of z = fused_pw_dw(x, w1, b1, wd, bd) for
    the cotangent dz. x, dz: (N, H, W, C) f32 or bf16, one dtype; w1
    (Cin, Cout) or (1, 1, Cin, Cout), b1 (Cout,), wd (9, Cout) or
    (3, 3, 1, Cout), f32. dw1 and dwd come back as (Cin, Cout) and
    (9, Cout)."""
    cin, cout = _check(x, w1, b1, wd, dz)
    if x.device.type == "cpu":
        return fused_pw_dw_bwd_plain(x, w1, b1, wd, dz)
    if x.device.type != "cuda":
        raise ValueError(f"fused_pw_dw_bwd: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or dz.dtype != x.dtype:
        raise TypeError(f"fused_pw_dw_bwd: x and dz must be both f32 or both "
                        f"bf16, not {x.dtype} and {dz.dtype}")
    w1, wd = w1.reshape(cin, cout), wd.reshape(9, cout)
    for name, t in (("x", x), ("dz", dz), ("w1", w1), ("b1", b1),
                    ("wd", wd)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_pw_dw_bwd: {name} must be contiguous "
                             f"on {x.device}")
        if name not in ("x", "dz") and t.dtype != torch.float32:
            raise TypeError(f"fused_pw_dw_bwd: {name} must be f32")
    n, h, w, _ = x.shape
    lib = LIB.get()
    mma = x.dtype == torch.bfloat16
    if mma:
        most = lib.yunet_convdp_bwd_mma_max_channels()
        if max(cin, cout) > most:
            raise ValueError(f"fused_pw_dw_bwd: {cin}->{cout} channels; the "
                             f"bf16 kernel takes at most {most} a side")
    elif lib.yunet_convdp_bwd_smem_bytes(cin, cout) > MAX_SMEM:
        raise ValueError(f"fused_pw_dw_bwd: {cin}->{cout} channels need more "
                         "shared memory than a block has")
    if n * -(-h // 8) * -(-w // 16) >= 2 ** 31:
        raise ValueError("fused_pw_dw_bwd: more tiles than an int counts")
    dx = torch.empty_like(x)
    length = lib.yunet_convdp_bwd_acc_len(cin, cout)
    # the reduction writes every element; an empty input sums to zero
    grads = (torch.empty if x.numel() else torch.zeros)(
        length, dtype=torch.float32, device=x.device)
    if x.numel():
        blocks = lib.yunet_convdp_bwd_blocks(n, h, w)
        partial = torch.empty((blocks, length), dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            code = lib.yunet_convdp_backward(
                x.data_ptr(), dz.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                wd.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                grads.data_ptr(), n, h, w, cin, cout,
                int(mma), torch.cuda.current_stream().cuda_stream)
        check_cuda_status(lib, code, "fused_pw_dw_bwd")
        fused_pw_dw_bwd.launches += 1
        fused_pw_dw_bwd.launches_mma += int(mma)
    dw1, db1, dwd, dbd = torch.split(
        grads, [cin * cout, cout, 9 * cout, cout])
    return dx, dw1.view(cin, cout), db1, dwd.view(9, cout), dbd


# every launch, and those of the bf16 (tensor-core) route alone
fused_pw_dw_bwd.launches = 0
fused_pw_dw_bwd.launches_mma = 0


class _FusedPwDw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, wd, bd):
        ctx.save_for_backward(x, w1, b1, wd)
        return fused_conv_dp(x, w1, b1, wd, bd, relu=False)

    @staticmethod
    def backward(ctx, dz):
        x, w1, b1, wd = ctx.saved_tensors
        dx, dw1, db1, dwd, dbd = fused_pw_dw_bwd(
            x, w1, b1, wd, dz.to(x.dtype).contiguous())
        return (dx, dw1.reshape(w1.shape), db1, dwd.reshape(wd.shape),
                dbd)


def fused_pw_dw(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                wd: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """z = depthwise3x3(pointwise(x, w1, b1), wd, bd), differentiable in
    all five arguments. x: (N, H, W, Cin) f32 or bf16, contiguous; w1
    (Cin, Cout) or (1, 1, Cin, Cout), b1 (Cout,), wd (9, Cout) or
    (3, 3, 1, Cout), bd (Cout,), all f32. Returns (N, H, W, Cout) in x's
    dtype."""
    return _FusedPwDw.apply(x, w1, b1, wd, bd)
