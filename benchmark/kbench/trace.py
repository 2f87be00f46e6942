r"""What a ``torch.profiler`` trace of the traced stretch says about the device.

The harness marks the stretch with a ``record_function`` annotation
(``bench.stretch``) and times its own calls into the program's layers
(``map_batch``, ``finish_batch``, ``request``) on the host clock, whatever
thread makes them; the trace's device events are kernels, copies and
memsets.  From these:

- ``busy_s``: the union of device intervals inside the stretch;
- ``kernel_s``: the summed time of kernels alone;
- ``device_ops``: device time by operation name, largest first;
- ``idle_gaps``: the longest stretches with nothing on the device, each
  named by the harness spans open at its middle (``no stage open`` when
  none is: in a stream, the wait for the ingest pool).
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "bench.stretch"


@dataclass
class DeviceSummary:
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list[tuple[str, float]] = field(default_factory=list)
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)


def _merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def summarize(events: list[dict], host: list[tuple[float, float, str]], top: int = 10) -> DeviceSummary:
    r"""Summarise Chrome-trace ``events`` (times in microseconds) over the stretch; ``host``
    holds the harness's spans ``(start, end, name)`` in seconds from the stretch's start."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH]
    if not spans:
        raise ValueError("the trace holds no bench.stretch annotation")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    dev = []
    by_name: dict[str, float] = defaultdict(float)
    kernel_us = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[str(e["name"])[:120]] += b - a
        if e["cat"] == "kernel":
            kernel_us += b - a
    busy = _merged(dev)
    host = [(lo + a * 1e6, lo + b * 1e6, name) for a, b, name in host]
    gaps = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            open_spans = sorted({name for s, t, name in host if s <= mid <= t})
            gaps.append(("+".join(open_spans) or "no stage open", (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(((name, us / 1e6) for name, us in by_name.items()), key=lambda kv: -kv[1])
    return DeviceSummary(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=kernel_us / 1e6,
        device_ops=ops[:top],
        idle_gaps=gaps[:top],
    )


def read_chrome_trace(path: str | Path) -> list[dict]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data
