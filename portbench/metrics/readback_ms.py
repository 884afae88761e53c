"""readback_ms.<scope>: the median over the traced slice's calls of the
call's ``yunet.readback`` span (the host waiting on the card, then the
copy back), in ms. Layer: device."""

from ..yardstick.spans import per_call_ms


def read(drv):
    return per_call_ms(drv.trace, "yunet.readback")
