r"""The program's own spans and counts, for the per-layer readers and for a trace's idle time.

With profiling on, the program keeps a recording of its spans
(``kaptive_tpu_torch.utils.profiling.recording``: each span's name,
``perf_counter_ns`` start and end, thread, request and the counts added in
it); the harness starts a new recording at the traced stretch's start
(``reset_phases``).  The stretch's spans are those that start before the
stretch's last row was stamped.  A program that keeps no such recording gives
``None``, so its metrics are left out.

Over a Chrome trace whose events hold the program's spans on the trace's
clock (``profiling.trace_events``; the command line's ``--profile`` trace
holds them as events of category ``kaptive``), :func:`idle_by_span` names
each stretch of idle card time by the innermost program span open over it,
and :func:`collect_lag` says how far each ``dp.collect`` span ends from the
last kernel of its sweep.  Run as a script on such a trace, this prints both.
"""

from __future__ import annotations

import bisect
import heapq
import json
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REQUEST = "type.request"  # the request's own span: time under it alone is glue no other span names


def stretch_spans(run):
    r"""``(start_ns, end_ns, spans)`` of the traced stretch on ``perf_counter_ns``, or ``None``."""
    try:
        from kaptive_tpu_torch.utils import profiling
    except ImportError:
        return None
    recording = getattr(profiling, "recording", None)
    if recording is None or run.stretch_rows <= 0:
        return None
    since, spans = recording()
    first = bisect.bisect_left(run.done_at, since / 1e9)  # rows stamped before the recording started
    last = first + run.stretch_rows - 1
    if not spans or last >= len(run.done_at):
        return None
    end = int(run.done_at[last] * 1e9)
    return since, end, [s for s in spans if s.start <= end]


def count_total(run, name: str) -> int | None:
    r"""The counts ``name`` added in the stretch's spans, summed (``None`` when none was added)."""
    got = stretch_spans(run)
    if got is None:
        return None
    counts = [s.counts[name] for s in got[2] if s.counts and name in s.counts]
    return sum(counts) if counts else None


def count_per_asm(run, name: str) -> float | None:
    r"""The counts ``name`` added in the stretch's spans, per assembly typed in it."""
    total = count_total(run, name)
    return None if total is None else total / run.stretch_rows


def unattributed_s(run) -> float | None:
    r"""Seconds of the stretch in which no program span but the request's own is open, on any thread."""
    got = stretch_spans(run)
    if got is None:
        return None
    lo, hi, spans = got
    if not any(s.name == REQUEST for s in spans):
        return None
    covered = _union([(max(s.start, lo), min(s.end, hi)) for s in spans if s.name != REQUEST])
    return (hi - lo - covered) / 1e9


def _union(intervals) -> float:
    total, reach = 0, None
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def _busy(events: list[dict], lo: float, hi: float) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(
        (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi))
        for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    ):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_span(events: list[dict], spans: list[tuple[float, float, str]], lo: float, hi: float,
                 fallback: list[tuple[float, float, str]] = ()) -> dict:
    r"""The card's idle time between ``lo`` and ``hi`` (trace µs), named by program span.

    ``spans`` are the program's ``(start, end, name)`` and ``fallback`` the harness's, both in
    trace µs.  Each idle gap is split where the innermost open program span (the one opened
    last) changes, and each piece named by it, else by the fallback spans open at its middle,
    else ``no stage open``.  Returns ``idle_s``, ``unattributed_s`` (idle while no program span
    but the request's own is open), ``pieces`` (``(name, seconds)``, longest first) and
    ``by_name`` (idle seconds a name).
    """
    busy = _busy(events, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    marks = []  # (time, order, kind, payload): closes before opens at one time
    for i, (a, b, name) in enumerate(spans):
        if b > a:
            marks += [(a, 1, "open", i), (b, 0, "close", i)]
    for j, (a, b) in enumerate(gaps):
        marks += [(a, 1, "gap", j), (b, 0, "gapend", j)]
    marks.sort()
    open_spans: set[int] = set()
    heap: list[tuple[float, int]] = []
    others = 0  # open program spans other than the request's own
    in_gap = False
    pieces: list[list] = []
    unattributed = 0.0
    t_prev = lo
    for t, _, kind, k in marks:
        if in_gap and t > t_prev:
            while heap and heap[0][1] not in open_spans:
                heapq.heappop(heap)
            name = spans[heap[0][1]][2] if heap else None
            if others == 0:
                unattributed += t - t_prev
            if pieces and pieces[-1][0] == name and pieces[-1][2] == t_prev:
                pieces[-1][1] += t - t_prev
                pieces[-1][2] = t
            else:
                pieces.append([name, t - t_prev, t, t_prev])
        t_prev = max(t_prev, t)
        if kind == "open":
            open_spans.add(k)
            heapq.heappush(heap, (-spans[k][0], k))
            others += spans[k][2] != REQUEST
        elif kind == "close":
            open_spans.discard(k)
            others -= spans[k][2] != REQUEST
        else:
            in_gap = kind == "gap"
    named = []
    for name, dur, end, start in pieces:
        if name is None:
            mid = (start + end) / 2
            name = "+".join(sorted({n for a, b, n in fallback if a <= mid <= b})) or "no stage open"
        named.append((name, dur / 1e6))
    by_name: dict[str, float] = defaultdict(float)
    for name, sec in named:
        by_name[name] += sec
    return {
        "idle_s": sum(b - a for a, b in gaps) / 1e6,
        "unattributed_s": unattributed / 1e6,
        "pieces": sorted(named, key=lambda p: -p[1]),
        "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
    }


def collect_lag(events: list[dict], spans: list[tuple[float, float, str, int]]) -> list[float]:
    r"""For each ``dp.collect`` span, µs from the end of the last kernel of its sweep to the span's
    end (negative: the span ended first).  A sweep's kernels start between its ``dp.launch``
    (the last one opened before, on the same thread) and the end of its ``dp.collect``;
    ``spans`` are ``(start, end, name, thread)`` in trace µs."""
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                     for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    starts = [a for a, _ in kernels]
    launches: dict[int, list[float]] = defaultdict(list)
    for a, _, name, tid in spans:
        if name == "dp.launch":
            launches[tid].append(a)
    lags = []
    for a, b, name, tid in spans:
        if name != "dp.collect":
            continue
        opened = sorted(x for x in launches[tid] if x <= a)
        if not opened:
            continue
        lo_i, hi_i = bisect.bisect_left(starts, opened[-1]), bisect.bisect_right(starts, b)
        if hi_i > lo_i:
            lags.append(b - max(end for _, end in kernels[lo_i:hi_i]))
    return lags


def _main(path: str) -> None:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    mine = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kaptive"]
    if not mine:
        sys.exit(f"{path}: no program spans (trace with KAPTIVE_PROFILE=1)")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in mine]
    lo = min(a for a, _, _ in spans)
    hi = max(b for _, b, _ in spans)
    idle = idle_by_span(events, spans, lo, hi)
    window = (hi - lo) / 1e6
    print(f"window {window:.6f} s, idle {idle['idle_s']:.6f} s, unattributed {idle['unattributed_s']:.6f} s "
          f"({100 * idle['unattributed_s'] / max(idle['idle_s'], 1e-12):.3f}% of idle)")
    for name, sec in list(idle["by_name"].items())[:15]:
        print(f"  idle under {name}: {sec:.6f} s")
    lags = collect_lag(events, [(a, b, n, e["tid"]) for (a, b, n), e in zip(spans, mine)])
    if lags:
        late = sum(lag >= -50 for lag in lags)
        print(f"dp.collect: {len(lags)} sweeps, {late} end no earlier than 50 us before their last kernel; "
              f"lag min {min(lags):.3f} us, max {max(lags):.3f} us")


if __name__ == "__main__":
    _main(sys.argv[1])
