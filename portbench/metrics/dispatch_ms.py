"""dispatch_ms.<scope>: the median over the window's calls of
``Detector.detect(timings=...)['dispatch']``, the host's time to queue
the device program, in ms. Layer: entry."""

import statistics


def read(drv):
    times = getattr(drv, "dispatch_s", None)
    return statistics.median(times) * 1e3 if times else None
