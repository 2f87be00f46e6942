r"""Spans, request ids and device trace capture: the port's one recorder.

The pipeline is a chain of device launches and host glue, and knowing which
phase dominates decides where the next kernel goes.  This module has

- :func:`phase_timer` — a nestable context manager that, when profiling is
  enabled (``$KAPTIVE_PROFILE=1`` or ``--profile``), keeps a :class:`Span`:
  its name, start and end on ``time.perf_counter_ns``, its thread, its parent
  (the span open on the same thread when it opened), the request it serves
  and the counts added inside it (:meth:`Span.add`).  Disabled, it costs one
  lookup of the flag and allocates nothing;
- :func:`request` / :func:`request_context` — a request id (one
  ``Serotyper.batch``, ``map_batch`` or ``finish_batch`` call, or one batch of
  the stream), carried to other threads through a copied ``contextvars``
  context;
- :func:`phase_report` — one stderr line per span name (count, total, mean),
  summed from the recorded spans;
- :func:`clock_anchor` / :func:`trace_events` — the recorder's clock tied to a
  running ``torch.profiler``'s, and the spans as Chrome-trace events on it;
- :func:`device_trace` — wraps ``torch.profiler`` and writes a Chrome trace
  (``chrome://tracing`` or Perfetto), the spans included as events of
  category ``kaptive`` on their threads, into its ``trace_dir``, else
  ``$KAPTIVE_TRACE_DIR``.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

from kaptive_tpu_torch.utils.metrics import count

__all__ = [
    "Span",
    "clock_anchor",
    "device_trace",
    "phase_report",
    "phase_timer",
    "phases_enabled",
    "recording",
    "request",
    "request_context",
    "reset_phases",
    "trace_events",
]

# os.environ's own table of encoded names and values: a lookup there allocates nothing.
_ENVIRON = os.environ._data
_FLAG = os.environ.encodekey("KAPTIVE_PROFILE")
_ON = os.environ.encodevalue("1")
_OFF = nullcontext()
CLOCK_MARK = "kaptive.clock"  # the profiler annotation an anchor brackets
_ANCHOR_TRIES = 3  # brackets an anchor takes; the narrowest sets the offset


def phases_enabled() -> bool:
    return _ENVIRON.get(_FLAG) == _ON


class _Local(threading.local):
    def __init__(self) -> None:
        self.stack: list[Span] = []


_LOCAL = _Local()
_REQUEST: contextvars.ContextVar[int | None] = contextvars.ContextVar("kaptive_request", default=None)
_REQUEST_IDS = itertools.count(1)


class _Recorder:
    r"""The closed spans and clock anchors since the last :func:`reset_phases`, appended under a lock."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.spans: list[Span] = []
        self.anchors: list[list[tuple[int, int]]] = []
        self.since = time.perf_counter_ns()

    def reset(self, anchor: list[tuple[int, int]] | None) -> None:
        with self.lock:
            self.spans, self.anchors, self.since = [], [anchor] if anchor else [], time.perf_counter_ns()


_RECORDER = _Recorder()


class Span:
    r"""One timed block: ``name``, ``start`` and ``end`` (``perf_counter_ns``), ``thread``
    (its native id), ``parent`` (the span open on the same thread when it opened, or
    ``None``), ``request`` (the open request's id, or ``None``) and ``counts`` (what
    :meth:`add` added inside it, or ``None``)."""

    __slots__ = ("name", "start", "end", "thread", "parent", "request", "counts")

    def __init__(self, name: str) -> None:
        self.name = name
        self.start = self.end = 0
        self.counts: dict[str, int] | None = None

    def __enter__(self) -> Span:
        stack = _LOCAL.stack
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_native_id()
        self.request = _REQUEST.get()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        _LOCAL.stack.pop()
        with _RECORDER.lock:
            _RECORDER.spans.append(self)

    def add(self, counter: str, n: int) -> None:
        r"""Add ``n`` to ``counter`` on this span and to the process's counter of that name."""
        count(counter, n)
        if self.counts is None:
            self.counts = {}
        self.counts[counter] = self.counts.get(counter, 0) + n


def phase_timer(name: str):
    r"""Record the block as a :class:`Span` named ``name`` when profiling is enabled.

    ``with phase_timer(name) as span:`` gives the span, or ``None`` when disabled, so
    counts that cost something to compute are computed only under ``if span:``.
    """
    if _ENVIRON.get(_FLAG) != _ON:  # phases_enabled(), inlined: the disabled path's one check
        return _OFF
    return Span(name)


class _Request:
    __slots__ = ("token",)

    def __enter__(self) -> int:
        rid = next(_REQUEST_IDS)
        self.token = _REQUEST.set(rid)
        return rid

    def __exit__(self, *exc) -> None:
        _REQUEST.reset(self.token)


def request():
    r"""Open a request: spans opened inside it carry its id.  Inside an open request, or
    with profiling disabled, this opens nothing."""
    if _ENVIRON.get(_FLAG) != _ON or _REQUEST.get() is not None:
        return _OFF
    return _Request()


def request_context() -> contextvars.Context:
    r"""A copy of this thread's context that carries a request id: the open request's, else a
    new one when profiling is enabled.  Work of that request on another thread runs in a copy
    of it (``pool.submit(ctx.copy().run, fn, ...)``); a context runs on one thread at a time."""
    ctx = contextvars.copy_context()
    if phases_enabled() and ctx.get(_REQUEST) is None:
        ctx.run(_REQUEST.set, next(_REQUEST_IDS))
    return ctx


def reset_phases() -> None:
    r"""Drop every recorded span and start a new recording; while ``torch.profiler`` records,
    anchor it to the profiler's clock (:func:`clock_anchor`) first."""
    _RECORDER.reset(_brackets())


def recording() -> tuple[int, list[Span]]:
    r"""``(since, spans)``: when the recording started (``perf_counter_ns`` of the last
    :func:`reset_phases`, else of the import) and its closed spans in the order they closed."""
    with _RECORDER.lock:
        return _RECORDER.since, list(_RECORDER.spans)


def clock_anchor() -> list[tuple[int, int]] | None:
    r"""Tie the recorder's clock to a running ``torch.profiler``'s.

    Brackets a ``record_function("kaptive.clock")`` block between two ``perf_counter_ns``
    readings, a few times, and keeps the brackets in the recording: the trace holds one
    event per bracket, so the offset between the clocks is known to within half the
    narrowest bracket.  Returns the brackets, or ``None`` (nothing kept) when no profiler
    is recording.
    """
    brackets = _brackets()
    if brackets:
        with _RECORDER.lock:
            _RECORDER.anchors.append(brackets)
    return brackets


def _brackets() -> list[tuple[int, int]] | None:
    if not torch.autograd._profiler_enabled():
        return None
    from torch.profiler import record_function

    brackets = []
    for _ in range(_ANCHOR_TRIES):
        t0 = time.perf_counter_ns()
        with record_function(CLOCK_MARK):
            pass
        brackets.append((t0, time.perf_counter_ns()))
    return brackets


def _trace_clock(events: list[dict], anchors: list[list[tuple[int, int]]]):
    r"""``perf_counter_ns -> trace µs`` from the anchors' brackets and the trace's ``kaptive.clock``
    events, paired in order; ``None`` when they do not pair.  Each anchor gives a point (its
    narrowest bracket's middle against its event's middle); the first sets the offset, and a
    last one a second or more later the rate, should the two clocks drift apart."""
    marks = sorted((e for e in events if e.get("ph") == "X" and e.get("name") == CLOCK_MARK), key=lambda e: e["ts"])
    if not anchors or len(marks) != sum(len(a) for a in anchors):
        return None
    points, k = [], 0
    for brackets in anchors:
        pairs = list(zip(brackets, marks[k : k + len(brackets)]))
        k += len(brackets)
        (t0, t1), mark = min(pairs, key=lambda p: p[0][1] - p[0][0])
        points.append(((t0 + t1) / 2, float(mark["ts"]) + float(mark.get("dur", 0.0)) / 2))
    (p0, u0), (p1, u1) = points[0], points[-1]
    rate = (u1 - u0) / (p1 - p0) if p1 - p0 >= 1e9 else 1e-3
    return lambda ns: u0 + (ns - p0) * rate


def trace_events(events: list[dict], anchors=None, spans=None) -> list[dict]:
    r"""The ``spans`` (default: the recording's) as Chrome-trace ``X`` events of category
    ``kaptive`` on the clock of the trace whose ``events`` hold the anchors' marks
    (``anchors``, default: the recording's); ``[]`` when the anchors do not pair with it."""
    if anchors is None or spans is None:
        with _RECORDER.lock:
            anchors = _RECORDER.anchors if anchors is None else anchors
            spans = list(_RECORDER.spans) if spans is None else spans
    to_us = _trace_clock(events, anchors)
    if to_us is None:
        return []
    pid = os.getpid()
    out = []
    for s in spans:
        args = {"request": s.request, "parent": s.parent.name if s.parent else None, **(s.counts or {})}
        ts = to_us(s.start)
        out.append({"ph": "X", "cat": "kaptive", "name": s.name, "pid": pid, "tid": s.thread,
                    "ts": ts, "dur": to_us(s.end) - ts, "args": args})
    return out


def phase_report(stream=None) -> dict[str, tuple[int, float]]:
    r"""Print the recorded spans' count, total and mean per name to stderr; returns {name: (count, total_s)}."""
    stream = stream or sys.stderr
    totals: dict[str, list[int]] = {}
    for s in recording()[1]:
        entry = totals.setdefault(s.name, [0, 0])
        entry[0] += 1
        entry[1] += s.end - s.start
    out = {}
    if totals:
        width = max(len(k) for k in totals)
        print("⏱  phase timings:", file=stream)
        for name, (n, total_ns) in sorted(totals.items(), key=lambda kv: -kv[1][1]):
            total = total_ns / 1e9
            mean = total / max(n, 1)
            print(
                f"   {name:<{width}}  n={n:<6d} total={total:8.3f}s  mean={mean * 1e3:9.3f}ms",
                file=stream,
            )
            out[name] = (n, total)
    return out


@contextmanager
def device_trace(trace_dir: str | os.PathLike | None = None):
    r"""Record a ``torch.profiler`` trace of the block into ``trace_dir``, else ``$KAPTIVE_TRACE_DIR``.

    Without either this does nothing.  CPU activity is always recorded, CUDA activity
    when a card is present.  The trace is written as
    ``kaptive_trace_<pid>_<time>.json``; the path is returned by the context.  The spans
    recorded inside the block (profiling enabled) are added to it on the profiler's
    clock, anchored at the block's start and end.
    """
    trace_dir = trace_dir or os.environ.get("KAPTIVE_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    out_dir = Path(trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"kaptive_trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        first = clock_anchor()
        yield path
        last = clock_anchor()
    prof.export_chrome_trace(str(path))
    lo, hi = first[0][0], last[-1][1]
    spans = [s for s in recording()[1] if s.end >= lo and s.start <= hi]
    if spans:
        with open(path, encoding="utf-8") as fh:
            trace = json.load(fh)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        events.extend(trace_events(events, [first, last], spans))
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
