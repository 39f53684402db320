"""Order statistics and interval arithmetic of the benchmark."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values`, linearly interpolated between
    the order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (`statistics.quantiles(values, n=4)`)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, lo: float, hi: float) -> list:
    """Each interval cut to [lo, hi]; empty ones dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def gaps(merged, lo: float, hi: float) -> list:
    """The (start, end) gaps of [lo, hi] that sorted disjoint intervals
    leave uncovered."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]
