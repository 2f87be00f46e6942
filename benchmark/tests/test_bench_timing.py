r"""The window's arithmetic over synthetic stamps: a stall moves both the rate and the tail."""

from __future__ import annotations

import pytest

from kbench.timing import percentile, rate


def test_percentile_is_nearest_rank():
    assert percentile([5.0], 95) == 5.0
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        percentile([], 95)


def test_one_stall_moves_the_rate_and_the_p95():
    # Batches of 16 requests, each batch 1 s from hand-in to rows out, back to back; then the
    # same with one 3 s stall inside the third batch, which all of its 16 requests wait out.
    def batches(stall_at: int | None):
        t, done, turns = 0.0, [], []
        for b in range(12):
            d = 1.0 + (3.0 if b == stall_at else 0.0)
            t += d
            done += [t] * 16
            turns += [d] * 16
        return done, turns

    done0, turns0 = batches(None)
    done1, turns1 = batches(2)
    assert rate(done0, 0.0, 10.0) == pytest.approx(16.0)
    assert rate(done1, 0.0, 10.0) == pytest.approx(11.2)
    assert percentile(turns0, 95) == pytest.approx(1.0)
    assert percentile(turns1, 95) == pytest.approx(4.0)


def test_rate_counts_only_the_window():
    assert rate([0.5, 1.0, 1.5, 2.5], 1.0, 1.0) == 2.0
