"""Order statistics of the benchmark's samples."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between the closest ranks: rank ``(n - 1)·q/100`` of the
    sorted samples (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

