r"""Genomic intervals, strand orientation, and vectorised SoA interval operations.

Capability parity with ``kaptive/core/interval.py``:
``Strand`` (:25-69), ``Interval`` (:75-262), ``Intervals`` (:268-591) including
``cull_overlaps`` (:435), ``cluster_spatial`` (:471), ``cluster_sequential``
(:495), ``arrange`` (:529) and ``shift`` (:412).

Design: the reference backs these with sequential Numba kernels
(``_cluster_kernel`` :595, ``_cluster_by_index_kernel`` :642,
``_cull_overlaps_kernel`` :698).  Here both clustering kernels are re-derived as
pure vectorised prefix operations (sort + segment-wise cumulative max + cumsum of
breaks), which are mathematically equivalent to the reference's sequential
single-linkage sweeps, while greedy overlap culling keeps the reference's exact
order semantics in one C pass of the host library.  These run on host: interval
counts in the typing pipeline are tiny (hundreds), far below device-dispatch
breakeven; the O(N) contig-scale work stays on the device in :mod:`kaptive_tpu_torch.ops`.
"""

from __future__ import annotations

from collections.abc import Iterable
from dataclasses import dataclass
from enum import IntEnum
from re import Match
from typing import Any

import numpy as np
import numpy.typing as npt

from kaptive_tpu_torch.core.collections import SoAContainer, soa
from kaptive_tpu_torch.native import hostio


class Strand(IntEnum):
    r"""Integer strand orientation with coercion from ``'+'``/``'-'``/``'1'``/``'-1'``."""

    FORWARD = 1
    REVERSE = -1
    UNSTRANDED = 0

    @classmethod
    def _missing_(cls, value: object) -> Strand:
        if isinstance(value, bytes):
            value = value.decode("ascii")
        aliases = {"+": 1, "1": 1, "+1": 1, "-": -1, "-1": -1}
        return cls(aliases[value]) if value in aliases else Strand.UNSTRANDED

    def __str__(self) -> str:
        return {1: "+", -1: "-"}.get(int(self), ".")


@dataclass(frozen=True, slots=True)
class Interval:
    r"""A single 0-based half-open genomic interval with strand orientation."""

    start: int
    end: int
    strand: Strand = Strand.UNSTRANDED

    def __len__(self) -> int:
        return self.end - self.start

    def __contains__(self, item: IntervalLike) -> bool:
        if isinstance(item, int):
            return self.start <= item < self.end
        other = Interval.from_item(item)
        return (self.start <= other.start) and (other.end <= self.end)

    def __add__(self, other: IntervalLike) -> Interval:
        r"""Union span; strand survives only when both agree."""
        that = Interval.from_item(other)
        merged_strand = self.strand if self.strand == that.strand else Strand.UNSTRANDED
        lo = self.start if self.start < that.start else that.start
        hi = self.end if self.end > that.end else that.end
        return Interval(lo, hi, merged_strand)

    __radd__ = __add__

    def shift(self, x: int, y: int | None = None) -> Interval:
        return Interval(self.start + x, self.end + (x if y is None else y), self.strand)

    def expand(self, left: int, right: int, clip_length: int | None = None) -> Interval:
        hi = self.end + right
        if clip_length is not None and hi > clip_length:
            hi = clip_length
        return Interval(max(0, self.start - left), hi, self.strand)

    def reverse_complement(self, length: int | None = None) -> Interval:
        pivot = self.end if length is None else length
        return Interval(pivot - self.end, pivot - self.start, Strand(-int(self.strand)))

    @classmethod
    def from_match(cls, item: Match, strand: Strand = Strand.UNSTRANDED) -> Interval:
        return cls(item.start(), item.end(), strand)

    @classmethod
    def from_int(cls, item: int, strand: Strand = Strand.UNSTRANDED, length: int | None = None) -> Interval:
        pos = item + length if (item < 0 and length is not None) else item
        return cls(pos, pos + 1, strand)

    @classmethod
    def from_slice(cls, item: slice, strand: Strand = Strand.UNSTRANDED, length: int | None = None) -> Interval:
        start = 0 if item.start is None else item.start
        stop = length if item.stop is None else item.stop
        if stop is None:
            raise ValueError("Cannot create Interval from slice with None stop without 'length'")
        if item.step == -1:  # reversed slice: flip to forward half-open bounds
            start, stop = stop + 1, start + 1
        return cls(start, stop, strand)

    # Coercion dispatch for interval-like inputs (scalar Interval wins, then
    # anything exposing .interval, then the per-type constructors).
    @classmethod
    def from_item(cls, item: IntervalLike, strand: Strand = Strand.UNSTRANDED, length: int | None = None) -> Interval:
        if isinstance(item, cls):
            return item
        if (interval := getattr(item, "interval", None)) is not None:
            return interval
        for kind, build in (
            (Match, lambda: cls.from_match(item, strand)),
            (int, lambda: cls.from_int(item, strand, length)),
            (slice, lambda: cls.from_slice(item, strand, length)),
        ):
            if isinstance(item, kind):
                return build()
        raise TypeError(item)


IntervalLike = slice | int | Match | Interval


def _segmentwise_shifted_cummax(values: npt.NDArray[np.int64], segment_starts: npt.NDArray[np.bool_]) -> npt.NDArray[np.int64]:
    r"""Running max of ``values`` within segments, shifted right by one position.

    ``segment_starts[i]`` marks the first element of each segment; the output at a
    segment's first position is undefined (returned as the value itself).  Computed
    without loops via the offset trick: add ``segment_rank * OFFSET`` (OFFSET larger
    than the value range), globally accumulate max, then subtract.
    """
    n = len(values)
    if n == 0:
        return values
    seg_rank = np.cumsum(segment_starts.astype(np.int64)) - 1
    vmin, vmax = int(values.min()), int(values.max())
    offset = np.int64(vmax - vmin + 1)
    keyed = values + seg_rank * offset
    cm = np.maximum.accumulate(keyed) - seg_rank * offset
    shifted = np.empty_like(cm)
    shifted[0] = values[0]
    shifted[1:] = cm[:-1]
    return shifted


@dataclass(frozen=True, slots=True)
class Intervals(SoAContainer):
    r"""Vectorised SoA collection of genomic intervals (starts/ends/strands + tracking indices).

    Batch protocol derived by :class:`~kaptive_tpu_torch.core.collections.SoAContainer`;
    integer indexing yields a scalar :class:`Interval` view.
    """

    starts: npt.NDArray[np.int32] = soa(np.int32)
    ends: npt.NDArray[np.int32] = soa(np.int32)
    strands: npt.NDArray[np.int8] = soa(np.int8)
    original_indices: npt.NDArray[np.int32] = soa(np.int32, default=None)

    def __post_init__(self) -> None:
        if self.original_indices is None:
            object.__setattr__(self, "original_indices", np.arange(len(self.starts), dtype=np.int32))

    @classmethod
    def from_intervals(cls, intervals: Iterable[Interval]) -> Intervals:
        rows = np.array(
            [(i.start, i.end, int(i.strand)) for i in intervals], dtype=np.int64
        ).reshape(-1, 3)
        if not len(rows):
            return cls.empty()
        return cls(
            rows[:, 0].astype(np.int32), rows[:, 1].astype(np.int32), rows[:, 2].astype(np.int8)
        )

    _DICT_COLUMNS = ("starts", "ends", "strands")

    def to_dict(self) -> dict[str, list]:
        return {col: getattr(self, col).tolist() for col in self._DICT_COLUMNS}

    @classmethod
    def from_dict(cls, d: dict) -> Intervals:
        cols = [np.asarray(d[col]) for col in cls._DICT_COLUMNS]
        return cls(cols[0].astype(np.int32), cols[1].astype(np.int32), cols[2].astype(np.int8))

    def _at(self, row: int) -> Interval:
        return Interval(self.starts[row], self.ends[row], self.strands[row])

    def __getitem__(self, item: Any) -> Interval | Intervals:
        if isinstance(item, (int, np.integer)):
            row = int(item) + (len(self) if item < 0 else 0)
            if not 0 <= row < len(self):
                raise IndexError("Batch index out of range")
            return self._at(row)
        # Explicit base call: slots=True dataclasses break zero-arg super().
        return SoAContainer.__getitem__(self, item)

    def shift(self, x: int | npt.NDArray[np.int32], y: int | npt.NDArray[np.int32] | None = None) -> Intervals:
        if len(self) == 0:
            return self
        return Intervals(
            np.asarray(self.starts + x, dtype=np.int32),
            np.asarray(self.ends + (x if y is None else y), dtype=np.int32),
            self.strands,
            self.original_indices,
        )

    def cull_overlaps(self, order: npt.NDArray[np.int32], max_overlap_fraction: float = 0.1,
                      group_by: npt.NDArray[np.integer] | None = None,
                      secondary_group_by: npt.NDArray[np.integer] | None = None) -> npt.NDArray[np.bool_]:
        r"""Greedy overlap culling with the reference's exact order semantics.

        Mirrors ``_cull_overlaps_kernel`` (``interval.py:698-751``): items are
        considered in ``order``; an item is kept unless it overlaps a previously
        kept item in the same (group, secondary group) by more than
        ``max_overlap_fraction`` of the shorter interval.  The sequential greedy
        structure is preserved (required for bit-identical results); it runs as
        one C pass of the host library (:func:`~kaptive_tpu_torch.native.hostio.cull_overlaps`),
        which compares an item with its own group's kept items alone.
        """
        n = len(self)
        if n == 0:
            return np.empty(0, dtype=np.bool_)
        gkey = None
        if group_by is not None or secondary_group_by is not None:
            g1 = np.zeros(n, dtype=np.int64) if group_by is None else np.asarray(group_by, dtype=np.int64)
            g2 = np.zeros(n, dtype=np.int64) if secondary_group_by is None else np.asarray(secondary_group_by, dtype=np.int64)
            # Combine groups into a single key, as the JAX package does.
            gkey = g1 * (int(g2.max()) + 1) + g2
        return hostio.cull_overlaps(self.starts, self.ends, gkey, order, max_overlap_fraction)

    def cluster_spatial(self, tolerance: int = 0,
                        group_by: npt.NDArray[np.integer] | None = None) -> npt.NDArray[np.int32]:
        r"""1-D single-linkage spatial clustering, vectorised.

        Equivalent to the reference's sequential sweep (``interval.py:595-639``):
        sort by (group, start, end); a new cluster starts where the group changes
        or the start exceeds the running maximum end (within the group) plus
        ``tolerance``.  Because starts are sorted, the within-group running max is
        a valid substitute for the within-cluster running max (once an item
        breaks past the global max, all later starts do too).
        """
        n = len(self)
        if n == 0:
            return np.empty(0, dtype=np.int32)
        groups = np.zeros(n, dtype=np.int64) if group_by is None else np.asarray(group_by, dtype=np.int64)
        order = np.lexsort((self.ends, self.starts, groups))
        s_sorted = self.starts[order].astype(np.int64)
        e_sorted = self.ends[order].astype(np.int64)
        g_sorted = groups[order]

        new_group = np.empty(n, dtype=np.bool_)
        new_group[0] = True
        new_group[1:] = g_sorted[1:] != g_sorted[:-1]
        prev_max_end = _segmentwise_shifted_cummax(e_sorted, new_group)
        breaks = new_group | (s_sorted > prev_max_end + tolerance)
        ids_sorted = np.cumsum(breaks.astype(np.int32)) - 1
        cluster_ids = np.empty(n, dtype=np.int32)
        cluster_ids[order] = ids_sorted
        return cluster_ids

    def cluster_sequential(self, tolerance: int = 0,
                           group_by: npt.NDArray[np.integer] | None = None,
                           enforce_strand: bool = False) -> npt.NDArray[np.int32]:
        r"""Index-based sequential clustering, vectorised (ref ``interval.py:495-527``)."""
        n = len(self)
        if n == 0:
            return np.empty(0, dtype=np.int32)
        groups = np.zeros(n, dtype=np.int64) if group_by is None else np.asarray(group_by, dtype=np.int64)
        indices = (
            self.original_indices.astype(np.int64)
            if self.original_indices is not None
            else np.zeros(n, dtype=np.int64)
        )
        if enforce_strand:
            order = np.lexsort((indices, self.strands, groups))
        else:
            order = np.lexsort((indices, groups))
        i_sorted = indices[order]
        g_sorted = groups[order]
        new_group = np.empty(n, dtype=np.bool_)
        new_group[0] = True
        new_group[1:] = g_sorted[1:] != g_sorted[:-1]
        if enforce_strand:
            st_sorted = self.strands[order]
            new_group[1:] |= st_sorted[1:] != st_sorted[:-1]
        prev_max_idx = _segmentwise_shifted_cummax(i_sorted, new_group)
        breaks = new_group | (np.abs(i_sorted - prev_max_idx) > tolerance + 1)
        ids_sorted = np.cumsum(breaks.astype(np.int32)) - 1
        cluster_ids = np.empty(n, dtype=np.int32)
        cluster_ids[order] = ids_sorted
        return cluster_ids

    def arrange(self, indices: npt.NDArray[np.integer], order: npt.NDArray[np.integer],
                starts: npt.NDArray[np.int32], ends: npt.NDArray[np.int32],
                strands: npt.NDArray[np.int8], gap: int = 500) -> Intervals:
        r"""Lay out intervals across disjoint contig pieces into one 1-D plot space (ref ``interval.py:529-591``)."""
        if len(self) == 0:
            return self
        n_pieces = len(starts)
        # Plot x-offset per piece: exclusive prefix sum of (length + gap) in
        # layout order, scattered back to piece ids (no sequential walk).
        ordered_span = (ends - starts).astype(np.int64)[order] + gap
        piece_plot_starts = np.zeros(n_pieces, dtype=np.int64)
        piece_plot_starts[np.asarray(order)] = np.concatenate(
            ([0], np.cumsum(ordered_span[:-1]))
        )

        idx = np.asarray(indices, dtype=np.int64)
        valid = (idx >= 0) & (idx < n_pieces)
        safe_idx = np.where(valid, idx, 0)
        p_s = starts[safe_idx].astype(np.int64)
        p_e = ends[safe_idx].astype(np.int64)
        orient = strands[safe_idx].astype(np.int64)
        offset = piece_plot_starts[safe_idx].astype(np.int64)
        fwd = orient >= 0
        new_starts = np.where(valid, np.where(fwd, offset + (self.starts - p_s), offset + (p_e - self.ends)), 0)
        new_ends = np.where(valid, np.where(fwd, offset + (self.ends - p_s), offset + (p_e - self.starts)), 0)
        new_strands = np.where(valid, np.where(fwd, self.strands, -self.strands), 0).astype(np.int8)
        return Intervals(
            new_starts.astype(np.int32), new_ends.astype(np.int32), new_strands, self.original_indices
        )
