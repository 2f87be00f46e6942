r"""Per-phase timers and device trace capture.

The pipeline is a chain of device launches and host glue, and knowing which
phase dominates decides where the next kernel goes.  This module has

- :func:`phase_timer` — a nestable context manager accumulating wall time per
  named phase (enabled with ``$KAPTIVE_PROFILE=1`` or ``--profile``; otherwise
  one environment lookup);
- :func:`phase_report` — one stderr line per phase (count, total, mean);
- :func:`device_trace` — wraps ``torch.profiler`` and writes a Chrome trace
  (``chrome://tracing`` or Perfetto) into its ``trace_dir``, else ``$KAPTIVE_TRACE_DIR``.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

__all__ = ["device_trace", "phase_report", "phase_timer", "phases_enabled", "reset_phases"]

_PHASES: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]


def phases_enabled() -> bool:
    return os.environ.get("KAPTIVE_PROFILE", "") == "1"


def reset_phases() -> None:
    _PHASES.clear()


@contextmanager
def phase_timer(name: str):
    r"""Accumulate wall time under ``name`` when profiling is enabled."""
    if not phases_enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        entry = _PHASES[name]
        entry[0] += 1
        entry[1] += time.perf_counter() - t0


def phase_report(stream=None) -> dict[str, tuple[int, float]]:
    r"""Print accumulated phase timings to stderr; returns {name: (count, total_s)}."""
    stream = stream or sys.stderr
    out = {}
    if _PHASES:
        width = max(len(k) for k in _PHASES)
        print("⏱  phase timings:", file=stream)
        for name, (count, total) in sorted(_PHASES.items(), key=lambda kv: -kv[1][1]):
            mean = total / max(count, 1)
            print(
                f"   {name:<{width}}  n={count:<6d} total={total:8.3f}s  mean={mean * 1e3:9.3f}ms",
                file=stream,
            )
            out[name] = (count, total)
    return out


@contextmanager
def device_trace(trace_dir: str | os.PathLike | None = None):
    r"""Record a ``torch.profiler`` trace of the block into ``trace_dir``, else ``$KAPTIVE_TRACE_DIR``.

    Without either this does nothing.  CPU activity is always recorded, CUDA activity
    when a card is present.  The trace is written as
    ``kaptive_trace_<pid>_<time>.json``; the path is returned by the context.
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
        yield path
    prof.export_chrome_trace(str(path))
