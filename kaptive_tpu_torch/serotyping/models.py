r"""Serotyping data models: gene states, problem flags, hit/piece containers, result record.

Capability parity with ``kaptive/serotyping/models.py``:
``GeneState`` (:31-44), ``SerotypingProblem`` bitflags + symbol table ``? + - * !``
(:47-92), ``GeneHits`` SoA (:96-364 incl. ``frames`` = ``(-q_starts)%3`` :252-259
and interval views :279-297), ``LocusPieces`` (:367-474), ``SerotypingResult``
(:477-654) with problem derivation (:538-558), ``to_locus_data`` (:596-621) and
lossless dict round-trip (:560-654).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum, IntFlag, auto
from typing import TYPE_CHECKING, Any, ClassVar

import numpy as np
import numpy.typing as npt

from kaptive_tpu_torch.core.collections import SoAContainer, soa
from kaptive_tpu_torch.core.interval import Intervals
from kaptive_tpu_torch.core.seq import Sequences

if TYPE_CHECKING:
    from kaptive_tpu_torch.compare import LocusData


class GeneState(IntEnum):
    r"""Mutually exclusive classification of a locus gene found in an assembly."""

    NORMAL = 0
    PARTIAL = 1
    TRUNCATED = 2
    NOVEL = 3


class SerotypingProblem(IntFlag):
    r"""Bitflag problems with a serotype call, rendered as ``? + - * !`` symbols."""

    NONE = 0
    FRAGMENTED = auto()
    UNEXPECTED_GENES = auto()
    MISSING_GENES = auto()
    NOVEL_GENES = auto()
    TRUNCATED_GENES = auto()

    SYMBOLS: ClassVar[tuple[bytes, ...]]

    def to_symbols(self) -> bytes:
        return self.SYMBOLS[self.value]


def _problem_symbol_table() -> tuple[bytes, ...]:
    r"""Precompute every flag combination's glyph string (report contract:
    the ``? + - * !`` glyphs and their order, ref ``models.py:82-92``)."""
    glyph_of = {
        SerotypingProblem.FRAGMENTED: b"?",
        SerotypingProblem.UNEXPECTED_GENES: b"+",
        SerotypingProblem.MISSING_GENES: b"-",
        SerotypingProblem.NOVEL_GENES: b"*",
        SerotypingProblem.TRUNCATED_GENES: b"!",
    }
    combos = 2 * SerotypingProblem.TRUNCATED_GENES.value  # highest single flag
    return tuple(
        b"".join(glyph for flag, glyph in glyph_of.items() if combo & flag)
        for combo in range(combos)
    )


SerotypingProblem.SYMBOLS = _problem_symbol_table()


@dataclass(slots=True, frozen=True)
class GeneHits(SoAContainer):
    r"""SoA container of classified gene alignments against the assembly.

    Batch protocol (len/getitem/empty/concat/dict round-trip) is derived from
    the :func:`~kaptive_tpu_torch.core.collections.soa` field declarations; ``bytes``
    fields coerce str inputs to width-fitted bytes arrays on construction.
    """

    gene_indices: npt.NDArray[np.int32] = soa(np.int32)
    q_starts: npt.NDArray[np.int32] = soa(np.int32)
    q_ends: npt.NDArray[np.int32] = soa(np.int32)
    t_indices: npt.NDArray[np.uint32] = soa(np.uint32)
    t_starts: npt.NDArray[np.int32] = soa(np.int32)
    t_ends: npt.NDArray[np.int32] = soa(np.int32)
    strands: npt.NDArray[np.int8] = soa(np.int8)
    is_expected: npt.NDArray[np.bool_] = soa(bool)
    is_inside: npt.NDArray[np.bool_] = soa(bool)
    is_extra: npt.NDArray[np.bool_] = soa(bool)
    expected_positions: npt.NDArray[np.int32] = soa(np.int32, optional=True)
    expected_strands: npt.NDArray[np.int8] = soa(np.int8, optional=True)
    gene_ids: npt.NDArray[np.bytes_] = soa(kind="bytes", optional=True)
    cluster_names: npt.NDArray[np.bytes_] = soa(kind="bytes", optional=True)
    product_descriptions: npt.NDArray[np.bytes_] = soa(kind="bytes", optional=True)
    coverages: npt.NDArray[np.float32] = soa(np.float32, optional=True)

    def _span_view(self, side: str) -> Intervals:
        lo, hi = getattr(self, f"{side}_starts"), getattr(self, f"{side}_ends")
        return Intervals(lo, hi, self.strands)

    @property
    def q_intervals(self) -> Intervals:
        return self._span_view("q")

    @property
    def t_intervals(self) -> Intervals:
        return self._span_view("t")

    @property
    def query_lengths(self) -> npt.NDArray[np.int32]:
        return self.q_ends - self.q_starts

    @property
    def target_lengths(self) -> npt.NDArray[np.int32]:
        return self.t_ends - self.t_starts

    @property
    def frames(self) -> npt.NDArray[np.int32]:
        r"""Reading-frame offsets: ``(-q_starts) % 3`` (ref :252-259)."""
        return (-self.q_starts) % 3


@dataclass(slots=True, frozen=True)
class LocusPieces(SoAContainer):
    r"""SoA container of locus fragment bounding coordinates across contigs."""

    ctg_indices: npt.NDArray[np.uint32] = soa(np.uint32)
    starts: npt.NDArray[np.int32] = soa(np.int32)
    ends: npt.NDArray[np.int32] = soa(np.int32)
    strands: npt.NDArray[np.int8] = soa(np.int8)


@dataclass(slots=True, frozen=True)
class SerotypingResult:
    r"""Immutable record of one *in silico* serotyping call (JSON round-trippable)."""

    kaptive_version: str
    database_name: str
    database_version: str
    database_organism: str
    database_taxon: int
    genome: str
    best_locus_idx: int
    best_locus_name: str
    best_locus_score: float
    best_locus_completeness: float
    locus_pieces: LocusPieces
    length_discrepancy: float
    locus_seqs: Sequences
    gene_hits: GeneHits
    gene_states: npt.NDArray[np.int8]
    gene_seqs: Sequences
    translations: Sequences
    percent_identity: float
    percent_coverage: float
    protein_identities: npt.NDArray[np.float32]
    phenotype: str
    typeable: bool
    missing_expected_genes: tuple[str, ...]
    problems: SerotypingProblem = field(init=False)

    def __post_init__(self) -> None:
        object.__setattr__(self, "problems", self._derive_problems())

    def _derive_problems(self) -> SerotypingProblem:
        r"""Condense the call into its problem flags.

        Flag conditions: FRAGMENTED = locus split over >1 piece; UNEXPECTED =
        a non-extra foreign gene sits inside the locus; MISSING = not every
        expected gene was recovered inside the locus; NOVEL / TRUNCATED =
        inside-locus genes in those states (PARTIAL counts as truncated).
        """
        hit = self.gene_hits
        inside_state = np.where(hit.is_inside, self.gene_states, np.int8(-1))
        conditions = {
            SerotypingProblem.FRAGMENTED: len(self.locus_pieces) > 1,
            SerotypingProblem.UNEXPECTED_GENES: bool(
                np.any(hit.is_inside & ~(hit.is_expected | hit.is_extra))
            ),
            SerotypingProblem.MISSING_GENES: self.best_locus_completeness < 1.0
            or bool(np.any(hit.is_expected & ~hit.is_inside)),
            SerotypingProblem.NOVEL_GENES: bool(np.any(inside_state == GeneState.NOVEL.value)),
            SerotypingProblem.TRUNCATED_GENES: bool(
                np.any(inside_state == GeneState.TRUNCATED.value)
                | np.any(inside_state == GeneState.PARTIAL.value)
            ),
        }
        flags = SerotypingProblem.NONE
        for flag, present in conditions.items():
            if present:
                flags |= flag
        return flags

    # Field groups driving the dict round-trip (the schema itself must match
    # the reference record for JSONL interchange, ref ``models.py:560-654``).
    _SCALAR_FIELDS: ClassVar[tuple[str, ...]] = (
        "kaptive_version", "database_name", "database_version",
        "database_organism", "database_taxon", "genome", "best_locus_idx",
        "best_locus_name", "best_locus_score", "best_locus_completeness",
        "length_discrepancy", "percent_identity", "percent_coverage",
        "phenotype", "typeable",
    )
    _SEQ_FIELDS: ClassVar[tuple[str, ...]] = ("locus_seqs", "gene_seqs", "translations")

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> SerotypingResult:
        kw: dict[str, Any] = {name: data[name] for name in cls._SCALAR_FIELDS}
        kw["missing_expected_genes"] = tuple(data.get("missing_expected_genes", []))
        kw["gene_states"] = np.array(data["gene_states"], dtype=np.int8)
        kw["protein_identities"] = np.array(data["protein_identities"], dtype=np.float32)
        kw["locus_pieces"] = LocusPieces.from_dict(data["locus_pieces"])
        kw["gene_hits"] = GeneHits.from_dict(data["gene_hits"])
        kw.update({name: Sequences.from_dict(data[name]) for name in cls._SEQ_FIELDS})
        return cls(**kw)

    def to_locus_data(self) -> "LocusData":
        from kaptive_tpu_torch.compare import LocusData

        hits = self.gene_hits
        core = hits.is_inside & ~hits.is_extra
        labels = np.char.decode(hits.product_descriptions[core], "utf-8")
        return LocusData(
            proteins=self.translations[core],  # type: ignore[arg-type]
            name=self.genome,
            backbone=hits.t_intervals[core],  # type: ignore[arg-type]
            pieces=self.locus_pieces,
            gene_ctg_indices=hits.t_indices[core],
            gene_states=self.gene_states[core],
            gene_descriptions=np.asarray(labels, dtype=object),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {name: getattr(self, name) for name in self._SCALAR_FIELDS}
        d["missing_expected_genes"] = self.missing_expected_genes
        d["problems"] = self.problems
        d["locus_pieces"] = self.locus_pieces.to_dict()
        d["gene_hits"] = self.gene_hits.to_dict()
        d["gene_states"] = self.gene_states
        d["protein_identities"] = self.protein_identities
        d.update({name: getattr(self, name).to_dict() for name in self._SEQ_FIELDS})
        return d
