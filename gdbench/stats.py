"""The arithmetic of the end-to-end and per-layer metrics."""
from __future__ import annotations

import math


def rate(units_per_frame, frames, window_s):
    """Units per second over every frame that finished in the window."""
    return units_per_frame * frames / window_s


def percentile(values, q):
    """Nearest-rank q-th percentile (0 < q <= 100) of all the values."""
    v = sorted(values)
    return v[max(1, math.ceil(q / 100.0 * len(v))) - 1]


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals):
    """(gap length, index of the interval after the gap) for every idle
    gap between the union's pieces, in time order."""
    out, cur_e = [], None
    order = sorted(range(len(intervals)), key=lambda i: intervals[i])
    for i in order:
        s, e = intervals[i]
        if cur_e is not None and s > cur_e:
            out.append((s - cur_e, i))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out
