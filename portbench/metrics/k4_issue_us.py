"""k4_issue_us.<scope>: the median ``yunet.k4`` span, the host's time for
one call of the K4 wrapper (``ops/convdp.py:fused_conv_dp``: checks, the
output's allocation, the ctypes launch), in us. Layer: kernels (K4's host
side)."""

from ..yardstick.spans import median_us


def read(drv):
    return median_us(drv.trace, "yunet.k4")
