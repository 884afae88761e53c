"""The program's spans in a traced slice, laid against the card's idle
time. A span is a host event named ``yunet.*`` (the port's
``utils/profiling.py:span``, a ``cpu_op``), which ``Trace`` keeps among
its host events, on the trace's one clock. Stages nest inside their call's span
(``yunet.detect``), and the K4 wrappers' spans (``yunet.k4``) inside
``yunet.trunk``. A program without spans leaves none of these events,
and every function here then returns None.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Tuple

CALLS = ("yunet.detect",)

Intervals = List[Tuple[float, float]]


def spans(trace, names) -> Intervals:
    """The (start, end) of the host events named in ``names``, in order."""
    names = {names} if isinstance(names, str) else set(names)
    return sorted((t0, t1) for t0, t1, n in trace.host if n in names)


def merged(xs: Intervals) -> Intervals:
    """The union of intervals given in order, as disjoint intervals."""
    out: List[List[float]] = []
    for a, b in xs:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle(trace) -> Intervals:
    """The slice less the union of the device intervals."""
    out, last = [], trace.lo
    for a, b in trace.busy_intervals():
        if a > last:
            out.append((last, a))
        last = max(last, b)
    if trace.hi > last:
        out.append((last, trace.hi))
    return out


def overlap_us(xs: Intervals, ys: Intervals) -> float:
    """The length of the intersection of two unions of intervals."""
    xs, ys = merged(xs), merged(ys)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(hi - lo, 0.0)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def per_call_ms(trace, name: str) -> Optional[float]:
    """The median over the slice's calls of the summed ``name`` spans
    inside each call's span, in ms; None without such spans."""
    if trace is None:
        return None
    inner = spans(trace, name)
    calls = spans(trace, CALLS)
    if not inner or not calls:
        return None
    starts = [a for a, _ in inner]
    sums = []
    for c0, c1 in calls:
        k = bisect.bisect_left(starts, c0)
        total = 0.0
        while k < len(inner) and inner[k][0] <= c1:
            if inner[k][1] <= c1:
                total += inner[k][1] - inner[k][0]
            k += 1
        sums.append(total)
    return statistics.median(sums) / 1e3


def median_us(trace, name: str) -> Optional[float]:
    """The median ``name`` span, in us; None without one."""
    if trace is None:
        return None
    got = [b - a for a, b in spans(trace, name)]
    return statistics.median(got) if got else None


def idle_in_ms(drv, name: str) -> Optional[float]:
    """The card's idle time inside ``name`` spans, a call of the slice, in
    ms; None without such spans."""
    if drv.trace is None or not drv.slice_calls:
        return None
    inner = spans(drv.trace, name)
    if not inner:
        return None
    return overlap_us(inner, idle(drv.trace)) / 1e3 / drv.slice_calls

