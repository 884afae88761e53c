"""Fused ConvDPUnit (1x1 pointwise -> 3x3 depthwise -> ReLU) — counterpart
of ``yunet_tpu/ops/convdp_pallas.py:fused_conv_dp``.

``fused_conv_dp`` keeps the JAX contract: NHWC in and out, stride 1, SAME
3x3 depthwise, BN already folded into (wd, bd); w1 as (1, 1, Cin, Cout) or
(Cin, Cout) and wd as (3, 3, 1, Cout) or (9, Cout). The pointwise result
y1 and the accumulator are f32; the output is x's dtype (f32 or bf16).

A CUDA tensor goes to one of the two hand-written kernels of
``csrc/convdp.cu``: bf16 with at most 64 channels each side (every YuNet
unit) to the tensor-core route, which takes w1 as three bf16 parts whose
sum is w1 exactly; f32, and bf16 above 64 channels, to the scalar route. A
CPU tensor goes to ``fused_conv_dp_plain``, the same function in plain
PyTorch.

The bf16 route's products are exact and its sums are f32 sums in another
order than the plain version's. Where an output cancels to near zero, that
order moves it by many of its own bf16 ulps, so the route is held to the
plain version by ``bf16_excess`` (at most ``BF16_EXCESS_LIMIT``), not by
one ulp alone.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F
from torch.autograd import profiler as _autograd_profiler

from ..utils.profiling import span
from ._build import (CSRC_DIR, NVCC_FLAGS, NativeLib, check_cuda_status,
                     cuda_signatures)

_P = ctypes.c_void_p
_I = ctypes.c_int
SOURCE = os.path.join(CSRC_DIR, "convdp.cu")
LIB = NativeLib(
    SOURCE, ["nvcc"] + NVCC_FLAGS,
    {**cuda_signatures(yunet_convdp_forward=[_P] * 6 + [_I] * 7 + [_P],
                       yunet_convdp_forward_mma=[_P] * 6 + [_I] * 6 + [_P]),
     "yunet_convdp_smem_bytes": (ctypes.c_size_t, [_I, _I]),
     "yunet_convdp_mma_max_channels": (_I, [])})
MAX_SMEM = 227 * 1024  # a block's dynamic shared memory limit on Hopper
# the bf16 route's check: what |kernel - plain| may exceed one bf16 ulp of
# the output by, in units of 2^-24 * S (see bf16_excess)
BF16_EXCESS_LIMIT = 2.0


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


def ulp_bf16(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of t (2^-8 at 0)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def bf16_excess(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor,
                wd: torch.Tensor) -> float:
    """The largest amount by which |got - want| exceeds one bf16 ulp of
    max(|got|, |want|), in units of 2^-24 * S[co], where S[co] = sum_t
    |wd[t, co]| * (max|x| * sum_ci |w1[ci, co]| + |b1[co]|) bounds the
    magnitude of every term that an output of channel co sums. Two f32
    evaluations of the same function that differ in the order of their
    sums stay well under BF16_EXCESS_LIMIT (at most 0.29 at the units of
    a 320^2 or 640^2 forward, emulated on the CPU); one that rounds w1 to
    16 bits (a hi + lo split) does not (9.99 and 13.3)."""
    cout = w1.shape[-1]
    s = wd.reshape(9, cout).float().abs().sum(0) * (
        x.float().abs().max() * w1.reshape(-1, cout).float().abs().sum(0)
        + b1.float().abs())
    g, t = got.float(), want.float()
    d = (g - t).abs() - ulp_bf16(torch.maximum(g.abs(), t.abs()))
    unit = (s * 2.0 ** -24).clamp_min(torch.finfo(torch.float32).tiny)
    return float((d / unit).max()) if d.numel() else 0.0


@functools.lru_cache(maxsize=None)
def _mma_route(cin: int, cout: int, bf16: bool) -> bool:
    """Whether a (cin -> cout) unit of this dtype takes the tensor-core
    route; raises where neither kernel takes it. Once per shape."""
    lib = LIB.get()
    if bf16 and max(cin, cout) <= lib.yunet_convdp_mma_max_channels():
        return True
    if lib.yunet_convdp_smem_bytes(cin, cout) > MAX_SMEM:
        raise ValueError(f"fused_conv_dp: {cin}->{cout} channels need more "
                         "shared memory than a block has")
    return False


def fused_conv_dp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  wd: torch.Tensor, bd: torch.Tensor, *,
                  relu: bool = True) -> torch.Tensor:
    """x: (N, H, W, Cin) -> (N, H, W, Cout) in x's dtype."""
    if not _autograd_profiler._is_profiler_enabled:     # no span to open
        return _fused_conv_dp(x, w1, b1, wd, bd, relu)
    with span("yunet.k4"):
        return _fused_conv_dp(x, w1, b1, wd, bd, relu)


def _fused_conv_dp(x, w1, b1, wd, bd, relu):
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
    bf16 = x.dtype == torch.bfloat16
    mma = _mma_route(cin, cout, bf16)
    if mma and n * -(-h // 8) * -(-w // 16) >= 2 ** 31:
        raise ValueError("fused_conv_dp: more tiles than the grid takes")
    if not mma and n > 65535:
        raise ValueError("fused_conv_dp: batch above the grid limit 65535")
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        lib = LIB.get()
        args = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wd.data_ptr(),
                bd.data_ptr(), out.data_ptr(), n, h, w, cin, cout, int(relu))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = (lib.yunet_convdp_forward_mma(*args, stream) if mma else
                    lib.yunet_convdp_forward(*args, int(bf16), stream))
        check_cuda_status(lib, code, "fused_conv_dp")
        fused_conv_dp.launches += 1
        fused_conv_dp.launches_mma += int(mma)
    return out


# every launch, and those of the bf16 (tensor-core) route alone
fused_conv_dp.launches = 0
fused_conv_dp.launches_mma = 0
