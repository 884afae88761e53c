"""trunk_idle_ms.<scope>: the card's idle time (the slice less the union
of the device intervals) inside the ``yunet.trunk`` spans, a call, in ms:
what the host's queueing of the trunk (29 K4 wrapper calls at YuNet-n)
leaves the card waiting. Layer: trunk."""

from ..yardstick.spans import idle_in_ms


def read(drv):
    return idle_in_ms(drv, "yunet.trunk")
