"""device_ms.<scope>: the card's busy time (the union of the device
intervals) in the traced slice, a call, in ms. Layer: device."""


def read(drv):
    tr = drv.trace
    if tr is None or not tr.device or not drv.slice_calls:
        return None
    return tr.busy_us() / 1e3 / drv.slice_calls
