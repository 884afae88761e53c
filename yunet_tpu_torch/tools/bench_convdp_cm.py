"""Micro-bench: the channels-major fused ConvDPUnit against the library
pw + dw and the NHWC fused unit — the twin of
``tools/misc/bench_convdp_cm.py``.

Each variant runs a chain of 20 units with tanh between them (the values
stay bounded) at stage 2 of yunet_n: 64 -> 64 channels, 160^2, N = 128,
bf16 activations, f32 weights.

  library  F.conv2d 1x1 + depthwise 3x3 in bf16 on the NHWC data, as a
           channels-last NCHW view
  cm       ops/convdp_cm.py:fused_conv_dp_cm (csrc/convdp_cm.cu) on the
           same data laid out as (H, C, W*N)
  nhwc     ops/convdp.py:fused_conv_dp (csrc/convdp.cu) on (N, H, W, C)

The variants take turns in 5 windows, each chain timed with CUDA events.
It prints the median ms per unit and GB/s over the least bytes a unit
moves (x read and z written once, bf16), the same count as the JAX bench.
It needs a CUDA device and has no CPU path:

    python -m yunet_tpu_torch.tools.bench_convdp_cm
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.convdp import fused_conv_dp
from ..ops.convdp_cm import fused_conv_dp_cm

N, H, W, CIN, COUT = 128, 160, 160, 64, 64
ITERS = 20
WINDOWS = 5
BYTES_MIN = H * W * N * (CIN + COUT) * 2  # x read + z written, bf16


def _variants(seed: int):
    """(inputs, unit functions) of the three variants on one card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    x_nhwc = randn(N, H, W, CIN, scale=0.1).to(torch.bfloat16)
    x_cm = x_nhwc.permute(1, 3, 2, 0).reshape(H, CIN, W * N).contiguous()
    w1, b1 = randn(CIN, COUT, scale=0.05), randn(COUT, scale=0.1)
    wd, bd = randn(9, COUT, scale=0.05), randn(COUT, scale=0.1)
    lib = (w1.t().reshape(COUT, CIN, 1, 1).to(torch.bfloat16),
           b1.to(torch.bfloat16),
           wd.t().reshape(COUT, 1, 3, 3).to(torch.bfloat16),
           bd.to(torch.bfloat16))

    def tanh(z):
        return torch.tanh(z.float()).to(torch.bfloat16)

    def library(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), lib[0], lib[1])
        y = F.conv2d(y, lib[2], lib[3], padding=1, groups=COUT)
        return tanh(y).permute(0, 2, 3, 1)

    units = {
        "library": (x_nhwc, library),
        "cm": (x_cm, lambda x: tanh(fused_conv_dp_cm(
            x, w1, b1, wd, bd, w=W, n=N, relu=False))),
        "nhwc": (x_nhwc, lambda x: tanh(fused_conv_dp(
            x, w1, b1, wd, bd, relu=False))),
    }
    return units


def run(windows: int = WINDOWS, iters: int = ITERS, seed: int = 0
        ) -> Dict[str, dict]:
    """{variant: {"ms_per_unit", "gb_s", "windows"}} on the current card."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_convdp_cm needs a CUDA device; it has no "
                           "CPU path")
    units = _variants(seed)

    def chain(x, unit):
        for _ in range(iters):
            x = unit(x)
        return x

    for x0, unit in units.values():       # warm-up: build, allocator
        chain(x0, unit)
    torch.cuda.synchronize()
    per_unit = {name: [] for name in units}
    for _ in range(windows):
        for name, (x0, unit) in units.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(x0, unit)
            end.record()
            end.synchronize()
            per_unit[name].append(start.elapsed_time(end) / iters)
    out = {}
    for name, v in per_unit.items():
        ms = statistics.median(v)
        out[name] = {"ms_per_unit": ms, "gb_s": BYTES_MIN / ms / 1e6,
                     "windows": v}
    return out


def main() -> int:
    res = run()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; stage 2 unit {CIN}->{COUT}, {H}x{W}, N={N}, bf16, "
          f"chain of {ITERS}, {WINDOWS} windows")
    for name, r in res.items():
        print(f"{name:8s} {r['ms_per_unit']:.4f} ms/unit  "
              f"{r['gb_s']:.1f} GB/s  windows "
              f"{[round(v, 4) for v in r['windows']]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
