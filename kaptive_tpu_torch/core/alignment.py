r"""SoA alignment records and BAM-encoded CIGAR containers.

Capability parity with ``kaptive/core/alignment.py``:
``CigarOp`` (:26-67), ``Cigars`` (:70-203) incl. ``swap_sides`` (:177),
``Alignment`` view (:206-259), ``Alignments`` (:262-868) incl. best-hit
selection (:606), overlap culling (:643), interval conversion (:753) and
contig-edge partial detection (:774-809).

Design: in the reference, alignments are ingested from rammappy's per-hit
iterators and a Numba CIGAR-string parser (:872-938).  Here the device mapper
(:mod:`kaptive_tpu_torch.ops.mapper`) produces flat arrays directly, so ingest is a
zero-copy constructor (:meth:`Alignments.from_arrays`); the CIGAR byte-string
parser is kept (vectorised numpy) for PAF/SAM interchange.
"""

from __future__ import annotations

from collections.abc import Iterable
from dataclasses import dataclass
from enum import IntEnum
from typing import Any, NamedTuple, Self

import numpy as np
import numpy.typing as npt

from kaptive_tpu_torch.core.collections import SoAContainer, cumulative_offsets, soa
from kaptive_tpu_torch.core.interval import Intervals, Strand


class CigarOp(IntEnum):
    r"""BAM CIGAR operation encodings (M/I/D/N/S/H/P/=/X/B)."""

    M = 0
    I = 1  # noqa: E741
    D = 2
    N = 3
    S = 4
    H = 5
    P = 6
    EQ = 7
    X = 8
    B = 9

    @property
    def char(self) -> str:
        return "MIDNSHP=XB"[self.value]


@dataclass(frozen=True, slots=True)
class Cigars:
    r"""Ragged batch of BAM-encoded uint32 CIGAR operations (len<<4 | op)."""

    data: npt.NDArray[np.uint32]
    offsets: npt.NDArray[np.int32]
    lengths: npt.NDArray[np.int32]

    def __len__(self) -> int:
        return len(self.offsets)

    def __getitem__(self, item: int | slice | npt.NDArray[Any] | list[int]) -> npt.NDArray[np.uint32] | Cigars:
        if isinstance(item, (int, np.integer)):
            if item < 0:
                item += len(self)  # type: ignore[assignment]
            if not 0 <= item < len(self):
                raise IndexError("Batch index out of range")
            lo = int(self.offsets[item])
            return self.data[lo : lo + int(self.lengths[item])]

        if isinstance(item, slice):
            indices = np.arange(len(self))[item]
        else:
            item_arr = np.asarray(item)
            indices = np.nonzero(item_arr)[0] if item_arr.dtype.kind == "b" else item_arr

        if len(indices) == 0:
            return self.empty()

        new_lengths = self.lengths[indices]
        new_offsets = cumulative_offsets(new_lengths)
        extracted = (
            np.concatenate([self.data[self.offsets[i] : self.offsets[i] + self.lengths[i]] for i in indices])
            if len(indices)
            else np.empty(0, dtype=np.uint32)
        )
        return Cigars(extracted, new_offsets, new_lengths)

    @classmethod
    def empty(cls) -> Cigars:
        return cls(np.empty(0, dtype=np.uint32), np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int32))

    @classmethod
    def concat(cls, batches: Iterable[Self]) -> Self:
        batches_list = list(batches)
        if not batches_list:
            return cls.empty()  # type: ignore[return-value]
        lengths = np.concatenate([b.lengths for b in batches_list])
        return cls(
            np.concatenate([b.data for b in batches_list]), cumulative_offsets(lengths), lengths
        )

    def swap_sides(self) -> Cigars:
        r"""Swap I and D ops (query/target role swap), vectorised (ref ``alignment.py:941-961``)."""
        ops = self.data & np.uint32(0xF)
        swapped = np.where(ops == 1, (self.data & ~np.uint32(0xF)) | 2,
                           np.where(ops == 2, (self.data & ~np.uint32(0xF)) | 1, self.data))
        return Cigars(swapped.astype(np.uint32), self.offsets, self.lengths)

    def to_dict(self) -> dict[str, list]:
        return {
            "data": self.data.tolist(),
            "offsets": self.offsets.tolist(),
            "lengths": self.lengths.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> Cigars:
        return cls(
            np.array(d["data"], dtype=np.uint32),
            np.array(d["offsets"], dtype=np.int32),
            np.array(d["lengths"], dtype=np.int32),
        )

    @classmethod
    def from_lists(cls, cigar_lists: list[npt.NDArray[np.uint32]]) -> Cigars:
        if not cigar_lists:
            return cls.empty()
        lengths = np.array([len(c) for c in cigar_lists], dtype=np.int32)
        return cls(np.concatenate(cigar_lists) if lengths.sum() else np.empty(0, dtype=np.uint32),
                   cumulative_offsets(lengths), lengths)

    def to_strings(self) -> list[bytes]:
        r"""Render each CIGAR back to its byte-string form (e.g. ``b"100M5D20M"``)."""
        out = []
        chars = b"MIDNSHP=XB"
        for i in range(len(self)):
            ops = self[i]
            out.append(b"".join(b"%d%c" % (int(o) >> 4, chars[int(o) & 0xF]) for o in ops))
        return out


_CIGAR_OP_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(b"MIDNSHP=XB"):
    _CIGAR_OP_LUT[_ch] = _i


def parse_cigar_string(cigar_bytes: bytes) -> npt.NDArray[np.uint32]:
    r"""Parse a CIGAR byte-string into BAM-encoded uint32 ops (ref ``alignment.py:872-938``), vectorised."""
    if not cigar_bytes:
        return np.empty(0, dtype=np.uint32)
    arr = np.frombuffer(cigar_bytes, dtype=np.uint8)
    op_codes = _CIGAR_OP_LUT[arr]
    is_op = op_codes != 255
    op_pos = np.nonzero(is_op)[0]
    if len(op_pos) == 0:
        return np.empty(0, dtype=np.uint32)
    # Parse the run lengths between op characters.
    is_digit = (arr >= 48) & (arr <= 57)
    digits = (arr - 48).astype(np.uint64)
    # Compute each digit's positional weight within its number via distance to next op char.
    next_op = np.empty(len(arr), dtype=np.int64)
    # next op index at or after each position (reverse cummin of op positions)
    idx_of_op = np.full(len(arr), len(arr), dtype=np.int64)
    idx_of_op[op_pos] = op_pos
    next_op = np.minimum.accumulate(idx_of_op[::-1])[::-1]
    weight_exp = next_op - np.arange(len(arr)) - 1
    weights = np.power(np.uint64(10), np.maximum(weight_exp, 0).astype(np.uint64))
    contrib = np.where(is_digit, digits * weights, np.uint64(0))
    # Sum digit contributions per op (segment sum keyed by next_op).
    lengths = np.zeros(len(arr) + 1, dtype=np.uint64)
    np.add.at(lengths, next_op[is_digit], contrib[is_digit])
    out = ((lengths[op_pos] << np.uint64(4)) | op_codes[op_pos].astype(np.uint64)).astype(np.uint32)
    return out


class Alignment(NamedTuple):
    r"""Read-only scalar view of one alignment record (ref ``alignment.py:206-259``)."""

    idx: int
    q_name: str
    q_length: int
    q_start: int
    q_end: int
    t_name: str
    t_length: int
    t_start: int
    t_end: int
    strand: Strand
    length: int
    match: int
    mismatch: int
    score: int
    quality: int
    cigar: npt.NDArray[np.uint32]
    is_primary: bool
    is_supplementary: bool
    is_spliced: bool
    divergence: float
    cs: bytes | None
    md: bytes | None


@dataclass(frozen=True, slots=True)
class Alignments(SoAContainer):
    r"""Vectorised SoA batch of alignment records (PAF-like fields + CIGARs).

    Batch protocol derived by :class:`~kaptive_tpu_torch.core.collections.SoAContainer`
    (name vocabularies ride along as ``shared`` fields, CIGARs as a nested
    container); integer indexing yields a scalar :class:`Alignment` view and
    ``concat`` merges/remaps the vocabularies.
    """

    q_name_ids: npt.NDArray[np.int32] = soa(np.int32)
    q_names_dict: tuple[str, ...] = soa((), kind="shared")
    q_lengths: npt.NDArray[np.int32] = soa(np.int32)
    q_starts: npt.NDArray[np.int32] = soa(np.int32)
    q_ends: npt.NDArray[np.int32] = soa(np.int32)
    t_name_ids: npt.NDArray[np.int32] = soa(np.int32)
    t_names_dict: tuple[str, ...] = soa((), kind="shared")
    t_lengths: npt.NDArray[np.int32] = soa(np.int32)
    t_starts: npt.NDArray[np.int32] = soa(np.int32)
    t_ends: npt.NDArray[np.int32] = soa(np.int32)
    strands: npt.NDArray[np.int8] = soa(np.int8)
    lengths: npt.NDArray[np.int32] = soa(np.int32)
    matches: npt.NDArray[np.int32] = soa(np.int32)
    mismatches: npt.NDArray[np.int32] = soa(np.int32)
    scores: npt.NDArray[np.int32] = soa(np.int32)
    qualities: npt.NDArray[np.uint8] = soa(np.uint8)
    cigars: Cigars = soa(Cigars, kind="container", optional=True)
    is_primary: npt.NDArray[np.bool_] = soa(bool)
    is_supplementary: npt.NDArray[np.bool_] = soa(bool)
    is_spliced: npt.NDArray[np.bool_] = soa(bool)
    divergence: npt.NDArray[np.float64] = soa(np.float64)
    cs: npt.NDArray[np.object_] = soa(object)
    md: npt.NDArray[np.object_] = soa(object)

    @property
    def q_names(self) -> npt.NDArray[np.object_]:
        return np.array([self.q_names_dict[i] for i in self.q_name_ids], dtype=object)

    @property
    def t_names(self) -> npt.NDArray[np.object_]:
        return np.array([self.t_names_dict[i] for i in self.t_name_ids], dtype=object)

    @property
    def q_aln_lens(self) -> npt.NDArray[np.int32]:
        return self.q_ends - self.q_starts

    @property
    def t_aln_lens(self) -> npt.NDArray[np.int32]:
        return self.t_ends - self.t_starts

    @property
    def q_covs(self) -> npt.NDArray[np.float64]:
        return np.divide(
            self.q_aln_lens, self.q_lengths,
            out=np.zeros_like(self.q_lengths, dtype=np.float64), where=self.q_lengths > 0,
        )

    @property
    def t_covs(self) -> npt.NDArray[np.float64]:
        return np.divide(
            self.t_aln_lens, self.t_lengths,
            out=np.zeros_like(self.t_lengths, dtype=np.float64), where=self.t_lengths > 0,
        )

    @classmethod
    def from_arrays(
        cls,
        q_name_ids: npt.NDArray[np.integer],
        q_names_dict: tuple[str, ...],
        q_lengths: npt.NDArray[np.integer],
        q_starts: npt.NDArray[np.integer],
        q_ends: npt.NDArray[np.integer],
        t_name_ids: npt.NDArray[np.integer],
        t_names_dict: tuple[str, ...],
        t_lengths: npt.NDArray[np.integer],
        t_starts: npt.NDArray[np.integer],
        t_ends: npt.NDArray[np.integer],
        strands: npt.NDArray[np.integer],
        matches: npt.NDArray[np.integer],
        edit_distances: npt.NDArray[np.integer],
        scores: npt.NDArray[np.integer],
        qualities: npt.NDArray[np.integer] | None = None,
        block_lengths: npt.NDArray[np.integer] | None = None,
        cigars: Cigars | None = None,
        is_primary: npt.NDArray[np.bool_] | None = None,
        divergence: npt.NDArray[np.floating] | None = None,
    ) -> Alignments:
        r"""Zero-copy ingest from the device mapper's flat output arrays.

        Replaces ``Alignments.from_mapping_iterators`` (ref ``alignment.py:391-474``)
        which looped over rammappy hit iterators; the device mapper already emits SoA.
        ``mismatches`` stores the edit distance, mirroring the reference's ingest of
        rammappy's ``edit_distance`` into the ``mismatches`` field (:431).
        """
        n = len(q_starts)
        if block_lengths is None:
            block_lengths = np.maximum(q_ends - q_starts, t_ends - t_starts)
        return cls(
            q_name_ids=np.asarray(q_name_ids, dtype=np.int32),
            q_names_dict=q_names_dict,
            q_lengths=np.asarray(q_lengths, dtype=np.int32),
            q_starts=np.asarray(q_starts, dtype=np.int32),
            q_ends=np.asarray(q_ends, dtype=np.int32),
            t_name_ids=np.asarray(t_name_ids, dtype=np.int32),
            t_names_dict=t_names_dict,
            t_lengths=np.asarray(t_lengths, dtype=np.int32),
            t_starts=np.asarray(t_starts, dtype=np.int32),
            t_ends=np.asarray(t_ends, dtype=np.int32),
            strands=np.asarray(strands, dtype=np.int8),
            lengths=np.asarray(block_lengths, dtype=np.int32),
            matches=np.asarray(matches, dtype=np.int32),
            mismatches=np.asarray(edit_distances, dtype=np.int32),
            scores=np.asarray(scores, dtype=np.int32),
            qualities=np.zeros(n, dtype=np.uint8) if qualities is None else np.asarray(qualities, dtype=np.uint8),
            cigars=cigars if cigars is not None else Cigars(
                np.empty(0, dtype=np.uint32), np.zeros(n, dtype=np.int32), np.zeros(n, dtype=np.int32)
            ),
            is_primary=np.ones(n, dtype=bool) if is_primary is None else np.asarray(is_primary, dtype=bool),
            is_supplementary=np.zeros(n, dtype=bool),
            is_spliced=np.zeros(n, dtype=bool),
            divergence=np.zeros(n, dtype=np.float64)
            if divergence is None
            else np.asarray(divergence, dtype=np.float64),
            cs=np.full(n, None, dtype=object),
            md=np.full(n, None, dtype=object),
        )

    @classmethod
    def concat(cls, batches: Iterable[Alignments]) -> Self:
        batches_list = list(batches)
        if not batches_list:
            return cls.empty()  # type: ignore[return-value]

        # Name vocabularies merge by value with id remapping, overriding the
        # mixin's equal-shared-values rule; array/container fields use the spec.
        kwargs: dict[str, Any] = {}
        for side in ("q", "t"):
            names_map: dict[str, int] = {}
            names_list: list[str] = []
            new_ids = []
            for b in batches_list:
                vocab = getattr(b, f"{side}_names_dict")
                remap = np.empty(len(vocab), dtype=np.int32)
                for i, name in enumerate(vocab):
                    if name not in names_map:
                        names_map[name] = len(names_list)
                        names_list.append(name)
                    remap[i] = names_map[name]
                ids = getattr(b, f"{side}_name_ids")
                new_ids.append(remap[ids] if len(ids) else ids)
            kwargs[f"{side}_name_ids"] = np.concatenate(new_ids)
            kwargs[f"{side}_names_dict"] = tuple(names_list)

        for name, kind, fspec in cls._soa_spec()[0]:
            if name in kwargs:
                continue
            vals = [getattr(b, name) for b in batches_list]
            kwargs[name] = fspec.concat(vals) if kind == "container" else np.concatenate(vals)
        return cls(**kwargs)  # type: ignore[return-value]

    # Scalar-view field -> backing column for the plain per-row attributes;
    # idx / names / strand / cigar need bespoke handling (vocab lookup, enum
    # coercion, ragged slice) and are built explicitly.
    _VIEW_COLS = dict(
        q_length="q_lengths", q_start="q_starts", q_end="q_ends",
        t_length="t_lengths", t_start="t_starts", t_end="t_ends",
        length="lengths", match="matches", mismatch="mismatches",
        score="scores", quality="qualities", is_primary="is_primary",
        is_supplementary="is_supplementary", is_spliced="is_spliced",
        divergence="divergence", cs="cs", md="md",
    )

    def __getitem__(self, item: int | slice | npt.NDArray[Any] | list[int]) -> Alignment | Alignments:
        if isinstance(item, (int, np.integer)):
            if item < 0:
                item += len(self)  # type: ignore[assignment]
            if item < 0 or item >= len(self):
                raise IndexError("Batch index out of range")
            return Alignment(
                idx=item,  # type: ignore[arg-type]
                q_name=self.q_names_dict[self.q_name_ids[item]],
                t_name=self.t_names_dict[self.t_name_ids[item]],
                strand=Strand(self.strands[item]),
                cigar=self.cigars[item],  # type: ignore[arg-type]
                **{f: getattr(self, col)[item] for f, col in self._VIEW_COLS.items()},
            )
        # Explicit base call: slots=True dataclasses break zero-arg super().
        return SoAContainer.__getitem__(self, item)

    def _rank_order(self, extra_primary_key: np.ndarray | None = None) -> npt.NDArray[np.int32]:
        r"""Visit order for selection/culling: score desc, then matches, then
        MAPQ, earliest record on full ties; an optional leading key (smaller
        first) takes precedence over everything."""
        keys: list[np.ndarray] = [
            -self.qualities.astype(np.int32),
            -self.matches,
            -self.scores,
        ]
        if extra_primary_key is not None:
            keys.append(extra_primary_key)
        return np.lexsort(tuple(keys)).astype(np.int32)

    def best(self, by_query: bool = True) -> Alignments:
        r"""Keep only each query's (or target's) top-ranked alignment.

        Ranking follows :meth:`_rank_order`; surviving records keep their
        original relative order.  (Semantics of ref ``alignment.py:606-641``.)
        """
        if len(self) == 0:
            return self
        from kaptive_tpu_torch.core.collections import group_leaders

        group = self.q_name_ids if by_query else self.t_name_ids
        winners = group_leaders(
            group, (self.scores, self.matches, self.qualities.astype(np.int32))
        )
        return self[np.sort(winners)]  # type: ignore[return-value]

    def cull_overlaps(
        self,
        max_overlap_fraction: float = 0.1,
        group_by: np.ndarray | None = None,
        priority_mask: np.ndarray | None = None,
        by_query: bool = True,
    ) -> Alignments:
        r"""Drop alignments nested under better ones on the same sequence.

        Greedy: records are visited best-first (priority records before all
        others, then :meth:`_rank_order`); a record survives unless it
        overlaps an already-kept record on the same (sequence, group) by more
        than ``max_overlap_fraction`` of the shorter span.  (Semantics of ref
        ``alignment.py:643-686``.)
        """
        if (n := len(self)) < 2:
            return self
        lead = None if priority_mask is None else ~np.asarray(priority_mask, dtype=bool)
        kept = self.to_intervals(by_query=by_query).cull_overlaps(
            order=self._rank_order(lead),
            max_overlap_fraction=max_overlap_fraction,
            group_by=self.q_name_ids if by_query else self.t_name_ids,
            secondary_group_by=group_by,
        )
        return self[kept]  # type: ignore[return-value]

    _SWAP_FIELDS = (
        ("q_name_ids", "t_name_ids"), ("q_names_dict", "t_names_dict"),
        ("q_lengths", "t_lengths"), ("q_starts", "t_starts"), ("q_ends", "t_ends"),
    )

    def swap_sides(self) -> Alignments:
        r"""Exchange query and target roles (CIGAR I/D ops swap accordingly)."""
        values = {f: getattr(self, f) for f in self.__dataclass_fields__}
        for qf, tf in self._SWAP_FIELDS:
            values[qf], values[tf] = values[tf], values[qf]
        values["cigars"] = self.cigars.swap_sides()
        return Alignments(**values)

    def to_intervals(self, by_query: bool = False) -> Intervals:
        starts = self.q_starts if by_query else self.t_starts
        ends = self.q_ends if by_query else self.t_ends
        return Intervals(
            starts=starts,
            ends=ends,
            strands=self.strands,
            original_indices=np.arange(len(self), dtype=np.int32),
        )

    def _clips(self) -> tuple[npt.NDArray[np.int32], npt.NDArray[np.int32]]:
        r"""Unaligned query bases facing the target's left / right end.

        On ``+`` the query head faces the target's left end; on ``-`` the
        roles flip.
        """
        fwd = self.strands == 1
        head = self.q_starts
        tail = self.q_lengths - self.q_ends
        return np.where(fwd, head, tail), np.where(fwd, tail, head)

    def is_partial_left(self, edge_tolerance: int = 0) -> npt.NDArray[np.bool_]:
        r"""Alignment runs off the contig's left edge with query sequence to spare."""
        left_clip, _ = self._clips()
        return (self.t_starts <= edge_tolerance) & (left_clip > 0)

    def is_partial_right(self, edge_tolerance: int = 0) -> npt.NDArray[np.bool_]:
        r"""Alignment runs off the contig's right edge with query sequence to spare."""
        _, right_clip = self._clips()
        return (self.t_ends >= self.t_lengths - edge_tolerance) & (right_clip > 0)

    def is_partial(self, edge_tolerance: int = 0) -> npt.NDArray[np.bool_]:
        r"""Alignment truncated by either contig edge (ref edge semantics)."""
        return self.is_partial_left(edge_tolerance) | self.is_partial_right(edge_tolerance)

    @classmethod
    def from_records(cls, records: Iterable[Alignment]) -> Alignments:
        r"""Build a batch from scalar views (inverse of integer indexing):
        columns come from the scalar-view map + the soa field spec, name
        vocabularies from insertion-ordered interning."""
        records_list = list(records)
        if not records_list:
            return cls.empty()
        kw: dict[str, Any] = {}
        for side in ("q", "t"):
            names_map: dict[str, int] = {}
            ids = [
                names_map.setdefault(getattr(r, f"{side}_name"), len(names_map))
                for r in records_list
            ]
            kw[f"{side}_names_dict"] = tuple(names_map)
            kw[f"{side}_name_ids"] = np.array(ids, dtype=np.int32)
        dtypes = {name: fspec for name, _, fspec in cls._soa_spec()[0]}
        for view_field, col in cls._VIEW_COLS.items():
            kw[col] = np.array(
                [getattr(r, view_field) for r in records_list], dtype=dtypes[col]
            )
        kw["strands"] = np.array([r.strand for r in records_list], dtype=np.int8)
        kw["cigars"] = Cigars.from_lists([r.cigar for r in records_list])
        return cls(**kw)
