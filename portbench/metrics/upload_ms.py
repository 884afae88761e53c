"""upload_ms.<scope>: the median over the traced slice's calls of the
call's ``yunet.upload`` span (``Detector._input``: the stack, the cast and
the host-to-device copy), in ms. Layer: entry."""

from ..yardstick.spans import per_call_ms


def read(drv):
    return per_call_ms(drv.trace, "yunet.upload")
