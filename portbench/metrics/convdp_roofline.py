"""convdp_roofline.<scope>: the least time for the fused ConvDPUnits of
the traced slice's forwards (every unit of the model at the call's
canvas and batch, peaks.convdp_bound_ms) over the device time of the
kernels that run them, in %. Layer: kernels (K4)."""

from ..yardstick.flops import convdp_units
from ..yardstick.peaks import convdp_bound_ms

KERNELS = ("convdp_mma_kernel", "convdp_kernel")


def read(drv):
    if drv.trace is None or not drv.slice_calls:
        return None
    us = drv.trace.kernel_us(KERNELS)
    if not us:
        return None
    h, w = drv.traffic["canvas"]
    batch = drv.traffic.get("batch", 1)
    units = [(batch, uh, uw, ci, co)
             for uh, uw, ci, co in convdp_units(drv.cfg["model"], h, w)]
    return 100.0 * convdp_bound_ms(units) * drv.slice_calls / (us / 1e3)
