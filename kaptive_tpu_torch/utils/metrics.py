r"""Process-global pipeline counters (kernel launches, fallbacks, DP shapes).

Cheap named counters and value-sets that the hot paths bump unconditionally
(a dict update under a lock, no flag gating) so a run can show which code path
ran: ``--profile`` and ``chip_smoke.py`` print them next to the phase table.

Conventions used by the pipeline:

- ``swg.cuda.{fill,traceback,traceback_cigar}`` — Hopper kernel launches, one per wrapper call
- ``swg.plain.{fill,traceback,traceback_cigar}`` — plain PyTorch versions (CPU tensors only)
- ``scan.cuda.rowcompact`` / ``scan.plain.rowcompact`` — the row-compact scan, likewise
- ``scan.cuda.flat`` / ``scan.plain.flat``  — the flat scan (``minimizer_scan``), likewise
- ``map.host_seed.{native,preseeded}``     — assemblies seeded by the C library, or ahead on the ingest pool
- ``map.host_fallback.{row_overflow,candidates,anchors,chains}``
                                           — genomes reseeded on host in device mode, by cause
- ``map.device_chained`` / ``map.host_chained`` — genomes chained on device vs host
- ``map.dense_upload``                     — genomes past the sparse upload's exception capacity
- ``swg.offlattice``                       — pairs that fell outside a frozen shape lattice
- ``screen.overflow``                      — screened genomes re-tallied from the flat scan
"""

from __future__ import annotations

import sys
import threading
from collections import defaultdict

_COUNTS: dict[str, int] = defaultdict(int)
_SHAPES: set[str] = set()
# Counters are bumped from several threads (the ingest pool, the streaming
# pipeline's device stage, the main thread) and the bench reads them as
# evidence of which code path ran — guard the read-modify-writes.
_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    r"""Increment counter ``name`` by ``n`` (thread-safe)."""
    with _LOCK:
        _COUNTS[name] += n


def record_shape(kind: str, *dims: int) -> bool:
    r"""Record a compiled-shape key; returns True the first time it is seen.

    Callers count it so a run shows how many distinct bucket shapes it dispatched.
    """
    key = f"{kind}:" + "x".join(str(d) for d in dims)
    with _LOCK:
        if key in _SHAPES:
            return False
        _SHAPES.add(key)
        _COUNTS[f"{kind}.new_shape"] += 1
    return True


def snapshot() -> dict[str, int]:
    return dict(_COUNTS)


def shapes() -> tuple[str, ...]:
    return tuple(sorted(_SHAPES))


def reset_metrics(keep_shapes: bool = False) -> None:
    r"""Clear counters; with ``keep_shapes`` the compiled-shape set survives,
    so a later ``*.new_shape`` count means a genuinely fresh compile (bench
    resets counters after warm-up but keeps the warm shape set)."""
    _COUNTS.clear()
    if not keep_shapes:
        _SHAPES.clear()


def metrics_report(stream=None) -> dict[str, int]:
    r"""Print accumulated counters (and the compiled-shape set) to stderr."""
    stream = stream or sys.stderr
    if _COUNTS:
        width = max(len(k) for k in _COUNTS)
        print("#  pipeline counters:", file=stream)
        for name in sorted(_COUNTS):
            print(f"   {name:<{width}}  {_COUNTS[name]}", file=stream)
    if _SHAPES:
        print(f"#  compiled DP shapes: {', '.join(sorted(_SHAPES))}", file=stream)
    return dict(_COUNTS)
