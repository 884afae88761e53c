"""launches.<scope>: kernel launches a call in the traced slice
(copies and fills not counted). Layer: entry, the host's issue."""


def read(drv):
    tr = drv.trace
    if tr is None or not drv.slice_calls:
        return None
    n = len(tr.kernels())
    return n / drv.slice_calls if n else None
