"""Percentiles over every sample."""

from __future__ import annotations

import math


def rank(n: int, q: float) -> int:
    """The nearest-rank index (0-based) of quantile q in n sorted values."""
    return max(0, math.ceil(q * n) - 1)


def percentile(values, q: float) -> float | None:
    """The nearest-rank q-quantile of all `values` (a missing sample is
    +inf and sorts last); None for no sample."""
    v = sorted(values)
    return v[rank(len(v), q)] if v else None


def beyond(n: int, q: float) -> int:
    """How many of n samples lie beyond the q-quantile's rank: the
    percentile is a tail and not a maximum only where this is 10 or more."""
    return n - rank(n, q) - 1 if n else 0
