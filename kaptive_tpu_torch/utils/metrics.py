r"""Process-global pipeline counters (kernel launches, fallbacks, work done).

Cheap named counters that the hot paths bump (a dict update under a lock) so
a run can show which code path ran and how much it did: ``--profile`` and
``chip_smoke.py`` print them next to the phase table.

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
- ``map.chains``                           — chains that became extension problems
- ``dp.cells_live`` / ``dp.cells_launched`` — band cells the DP pairs need (rows x ``2k+3``) and
                                           the cells launched (``b_pad x rows_max x w_pad``, padding included)

The last three are work counts, added only with profiling enabled, through
the span they are counted in (:meth:`kaptive_tpu_torch.utils.profiling.Span.add`).
"""

from __future__ import annotations

import sys
import threading
from collections import defaultdict

_COUNTS: dict[str, int] = defaultdict(int)
# Counters are bumped from several threads (the ingest pool, the streaming
# pipeline's device stage, the main thread) and the bench reads them as
# evidence of which code path ran — guard the read-modify-writes.
_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    r"""Increment counter ``name`` by ``n`` (thread-safe)."""
    with _LOCK:
        _COUNTS[name] += n


def snapshot() -> dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def reset_metrics() -> None:
    r"""Clear every counter."""
    with _LOCK:
        _COUNTS.clear()


def metrics_report(stream=None) -> dict[str, int]:
    r"""Print accumulated counters to stderr."""
    stream = stream or sys.stderr
    if _COUNTS:
        width = max(len(k) for k in _COUNTS)
        print("#  pipeline counters:", file=stream)
        for name in sorted(_COUNTS):
            print(f"   {name:<{width}}  {_COUNTS[name]}", file=stream)
    return dict(_COUNTS)
