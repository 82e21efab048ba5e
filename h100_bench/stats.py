"""Statistics of a run: tails over every sample, rates over the window."""

from __future__ import annotations

import math


def percentile(values, pct: float) -> float:
    """The pct-th percentile of every value, interpolated linearly between
    the two nearest ranks (numpy's default). Infinite values take part."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * pct / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == xs[lo]:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work over the whole window's time."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return work / seconds

