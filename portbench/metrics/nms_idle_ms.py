"""nms_idle_ms.<scope>: the card's idle time inside the ``yunet.nms``
spans (the device NMS with its top-k and the pack), a call, in ms.
Layer: NMS (K3)."""

from ..yardstick.spans import idle_in_ms


def read(drv):
    return idle_in_ms(drv, "yunet.nms")
