"""idle_pct.<scope>: the share of the traced slice in which no kernel,
copy or fill ran on the card: 100 x (1 - union of the device intervals /
the slice's length). Layer: device."""


def read(drv):
    tr = drv.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
