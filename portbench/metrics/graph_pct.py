"""graph_pct.<scope>: the share of the traced slice's calls (``yunet.detect``
spans) that hold a ``yunet.graph`` span, a call whose device program ran
as one replayed CUDA graph, in %. None without such spans (a program that
issues every launch itself). Layer: entry."""

import bisect

from ..yardstick.spans import CALLS, spans


def read(drv):
    if drv.trace is None:
        return None
    calls, graphs = spans(drv.trace, CALLS), spans(drv.trace, "yunet.graph")
    if not calls or not graphs:
        return None
    starts = [a for a, _ in graphs]
    held = 0
    for c0, c1 in calls:
        k = bisect.bisect_left(starts, c0)
        held += k < len(graphs) and graphs[k][1] <= c1
    return 100.0 * held / len(calls)
