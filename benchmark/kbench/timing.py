r"""The window's arithmetic: a rate over the whole window, a nearest-rank percentile over every request."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    r"""Nearest-rank ``q``-th percentile (0 < q <= 100): the smallest value with
    at least ``q`` percent of ``values`` at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ranked = sorted(values)
    return ranked[max(1, math.ceil(q / 100.0 * len(ranked))) - 1]


def rate(done_at: list[float], start: float, seconds: float) -> float:
    r"""Requests completed in ``[start, start + seconds]`` over the window's length."""
    end = start + seconds
    return sum(1 for t in done_at if start <= t <= end) / seconds
