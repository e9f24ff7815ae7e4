"""The window's arithmetic: rates over whole frames, percentiles over all
intervals, the union of device intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile (0 < q <= 100) of all ``values``:
    the smallest value that at least q% of them do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def rate(work: float, seconds: float) -> float:
    """Work over the seconds of the whole frames that did it."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return work / seconds


def union_seconds(intervals) -> float:
    """The seconds that at least one of the (start, end) intervals covers,
    each counted once where they overlap."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that none of the intervals
    covers, longest first."""
    out, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if cursor < hi:
        out.append((cursor, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])
