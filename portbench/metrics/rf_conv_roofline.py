"""rf_conv_roofline.<scope>: the least time for the convs of the traced
slice's forwards (every conv of the RetinaFace model at the call's canvas
and batch, conv by conv, with each level's class, box and landmark heads
merged into one conv that reads their map once, as the port runs them:
yardstick/retinaface.py:conv_bound_ms, times the slice's calls) over the union of the convolution kernels' device
intervals that ran them (``rf_conv_ms.conv_union_us``), in %. It reads
the same work whatever kernel runs the convs. Layer: kernels
(``csrc/scrfd_conv.cu`` through ``models/retinaface.py:
retinaface_conv``)."""

from ..yardstick.retinaface import conv_bound_ms
from .rf_conv_ms import conv_union_us


def read(drv):
    us = conv_union_us(drv.trace)
    if us is None or not drv.slice_calls:
        return None
    h, w = drv.traffic["canvas"]
    bound = conv_bound_ms(drv.cfg["model"], h, w,
                          drv.traffic.get("batch", 1))
    return 100.0 * bound * drv.slice_calls / (us / 1e3)
