"""The card's peaks and the least time for a piece of work, frozen: a copy
of ``chip_smoke.py``'s H100 constants and ``bound_ms``, and of the byte
and operation counts of ``phase_convdp``.

Each count is of the work the inputs need, whatever kernel does it:
each input byte read once, each output byte written once, and the
operations this data needs.
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense rates, 700 W): HBM bytes/s, f32
# FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def bound_ms(nbytes: float, ops: float, peak: float) -> float:
    """The least time (ms) for the work on an H100: the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    return max(nbytes / HBM_BPS, ops / peak) * 1e3


def convdp_bound_ms(units) -> float:
    """Fused ConvDPUnits (pointwise then depthwise): units is a list of
    (n, h, w, cin, cout). Bytes: bf16 activations in and out, f32
    weights; operations: the pointwise and depthwise multiply-adds at the
    bf16 tensor-core peak. Summed unit by unit."""
    return sum(bound_ms(n * h * w * (ci + co) * 2 + (ci * co + 11 * co) * 4,
                        2 * n * h * w * co * (ci + 10), BF16_FLOPS)
               for n, h, w, ci, co in units)
