r"""TSV report rows: classic Kaptive format and the PHA4GE standard.

Capability parity with ``kaptive/serotyping/io.py``:
``ReportRow`` (:19-97), the 22-column Kaptive row (:100-296) and the PHA4GE
row (:299-382).  The column rosters, the legacy header transform, and every
``%.2f%%`` cell format are byte-level output contracts; everything else is
this repo's own machinery — a row is one cell dict validated against a
``COLUMNS`` spec string (not a dataclass with one field per column), header
label transforms are paired ``_label``/``_column`` hooks, and the per-gene
detail strings are driven by small data tables.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator
from typing import Self

import numpy as np

from kaptive_tpu_torch.serotyping.models import GeneState, SerotypingProblem, SerotypingResult
from kaptive_tpu_torch.utils.profiling import phase_timer

# Gene-state annotations appended to per-gene detail entries; NORMAL is untagged.
_STATE_TAGS = {
    GeneState.PARTIAL.value: b",partial",
    GeneState.TRUNCATED.value: b",truncated",
    GeneState.NOVEL.value: b",below_id_threshold",
}

# PHA4GE free-text notes per problem flag, in report order (ref io.py:340-360).
_PROBLEM_NOTES: tuple[tuple[SerotypingProblem, object], ...] = (
    (SerotypingProblem.TRUNCATED_GENES, lambda r: b"truncated gene/s in locus"),
    (SerotypingProblem.NOVEL_GENES, lambda r: b"low identity gene/s"),
    (SerotypingProblem.FRAGMENTED, lambda r: b"match broken into %d pieces" % len(r.locus_pieces)),
    (SerotypingProblem.MISSING_GENES, lambda r: b"missing expected gene/s"),
    (SerotypingProblem.UNEXPECTED_GENES, lambda r: b"unexpected gene/s in locus"),
)


def _detail_cell(result: SerotypingResult, mask: np.ndarray) -> bytes:
    r"""``gene,id%,cov%[,state]`` entries for the selected hits, ``;``-joined."""
    entries = []
    for i in np.flatnonzero(mask):
        entry = b"%s,%.2f%%,%.2f%%" % (
            result.gene_seqs.ids[i].encode("utf-8"),
            result.protein_identities[i],
            result.gene_hits.coverages[i],
        )
        entries.append(entry + _STATE_TAGS.get(int(result.gene_states[i]), b""))
    return b";".join(entries)


def _tally_cell(found: int, roster: int) -> bytes:
    r"""``found / roster (pct%)`` against the expected-gene roster size."""
    if roster <= 0:
        return b"0 / 0 (0.00%)"
    return b"%d / %d (%.2f%%)" % (found, roster, found / roster * 100.0)


def _discrepancy_cell(value: float | None) -> bytes:
    return b"n/a" if value is None or np.isnan(value) else b"%d" % int(value)


def _confidence_cell(result: SerotypingResult) -> bytes:
    return b"Typeable" if result.typeable else b"Untypeable"


class ReportRow:
    r"""Spec-driven TSV row.

    Cell order and names come from the class-level ``COLUMNS`` roster;
    ``PRESET`` supplies constant cells a caller may omit.  Storage is a
    single dict, rendered with ``bytes(row)`` and re-read with ``read_tsv``.
    """

    COLUMNS: tuple[str, ...] = ()
    PRESET: dict[str, bytes] = {}

    __slots__ = ("_cells",)

    def __init__(self, **cells: bytes) -> None:
        merged = dict(self.PRESET)
        merged.update(cells)
        if gaps := [name for name in self.COLUMNS if name not in merged]:
            raise TypeError(f"{type(self).__name__} is missing cells: {gaps}")
        self._cells = merged

    def __getattr__(self, name: str) -> bytes:
        try:
            return object.__getattribute__(self, "_cells")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __eq__(self, other: object) -> bool:
        return type(other) is type(self) and other._cells == self._cells

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._cells!r})"

    def __bytes__(self) -> bytes:
        with phase_timer("report.row"):
            row = self._cells
            return b"\t".join(row[name] for name in self.COLUMNS) + b"\n"

    # Header label <-> column name transform hooks (identity by default).

    @staticmethod
    def _label(column: str) -> bytes:
        return column.encode("utf-8")

    @staticmethod
    def _column(label: bytes) -> str:
        return label.decode("utf-8")

    @classmethod
    def header(cls) -> bytes:
        return b"\t".join(map(cls._label, cls.COLUMNS)) + b"\n"

    @classmethod
    def from_result(cls, result: SerotypingResult) -> Self:
        raise NotImplementedError

    @classmethod
    def read_tsv(cls, lines: Iterable[bytes]) -> Iterator[Self]:
        r"""Re-parse rows previously serialised by this class (column-order
        tolerant; unknown columns are ignored)."""
        stream = iter(lines)
        header_line = next(stream, None)
        if header_line is None:
            return
        names = [cls._column(tok) for tok in header_line.rstrip(b"\r\n").split(b"\t")]
        roster = set(cls.COLUMNS)
        for raw in stream:
            if raw := raw.rstrip(b"\r\n"):
                found = zip(names, raw.split(b"\t"))
                yield cls(**{name: cell for name, cell in found if name in roster})


class KaptiveRow(ReportRow):
    r"""Classic Kaptive TSV row (22 columns, legacy-compatible header)."""

    __slots__ = ()

    # Column roster — a byte-level output contract (ref io.py:100-296).
    COLUMNS = tuple(
        "Kaptive_version Database_name Database_version Assembly"
        " Best_match_locus Best_match_type Match_confidence Problems"
        " Identity Coverage Length_discrepancy"
        " Expected_genes_in_locus Expected_genes_in_locus_details"
        " Missing_expected_genes"
        " Other_genes_in_locus Other_genes_in_locus_details"
        " Expected_genes_outside_locus Expected_genes_outside_locus_details"
        " Other_genes_outside_locus Other_genes_outside_locus_details"
        " Truncated_genes_details Extra_genes_details".split()
    )

    # Columns whose cell is a UTF-8 passthrough of a result attribute.
    _VERBATIM = (
        ("Kaptive_version", "kaptive_version"),
        ("Database_name", "database_name"),
        ("Database_version", "database_version"),
        ("Assembly", "genome"),
        ("Best_match_locus", "best_locus_name"),
        ("Best_match_type", "phenotype"),
    )

    @staticmethod
    def _label(column: str) -> bytes:
        r"""Column name -> classic header label (``_details`` -> ``, details``)."""
        return column.replace("_details", ", details").replace("_", " ").encode("utf-8")

    @staticmethod
    def _column(label: bytes) -> str:
        return label.replace(b", details", b"_details").replace(b" ", b"_").decode("utf-8")

    @classmethod
    def from_result(cls, result: SerotypingResult) -> "KaptiveRow":
        with phase_timer("report.row"):
            hits = result.gene_hits
            category = {  # hit partition: (inside?, expected/other/extra)
                ("in", "exp"): hits.is_inside & hits.is_expected,
                ("out", "exp"): ~hits.is_inside & hits.is_expected,
                ("in", "other"): hits.is_inside & ~hits.is_expected & ~hits.is_extra,
                ("out", "other"): ~hits.is_inside & ~hits.is_expected & ~hits.is_extra,
            }
            distinct = {
                key: len(np.unique(hits.gene_indices[mask])) for key, mask in category.items()
            }
            roster_size = distinct["in", "exp"] + distinct["out", "exp"] + len(
                result.missing_expected_genes
            )
            broken = np.isin(
                result.gene_states, (GeneState.TRUNCATED.value, GeneState.PARTIAL.value)
            )
            cells = {column: getattr(result, attr).encode("utf-8") for column, attr in cls._VERBATIM}
            cells.update(
                Match_confidence=_confidence_cell(result),
                Problems=result.problems.to_symbols(),
                Identity=b"%.2f%%" % result.percent_identity,
                Coverage=b"%.2f%%" % result.percent_coverage,
                Length_discrepancy=_discrepancy_cell(result.length_discrepancy),
                Expected_genes_in_locus=_tally_cell(distinct["in", "exp"], roster_size),
                Expected_genes_in_locus_details=_detail_cell(result, category["in", "exp"]),
                Missing_expected_genes=b";".join(
                    name.encode("utf-8") for name in result.missing_expected_genes
                ),
                Other_genes_in_locus=b"%d" % distinct["in", "other"],
                Other_genes_in_locus_details=_detail_cell(result, category["in", "other"]),
                Expected_genes_outside_locus=_tally_cell(distinct["out", "exp"], roster_size),
                Expected_genes_outside_locus_details=_detail_cell(result, category["out", "exp"]),
                Other_genes_outside_locus=b"%d" % distinct["out", "other"],
                Other_genes_outside_locus_details=_detail_cell(result, category["out", "other"]),
                Truncated_genes_details=_detail_cell(result, broken),
                Extra_genes_details=_detail_cell(result, hits.is_extra),
            )
            return cls(**cells)


class Pha4geRow(ReportRow):
    r"""PHA4GE genotyping-specification TSV row."""

    __slots__ = ()

    # Column roster — the PHA4GE specification order (ref io.py:299-382).
    COLUMNS = tuple(
        "sample genotyping_method genotyping_schema_taxon"
        " genotyping_database_name genotyping_database_version"
        " genotyping_schema_name genotyping_software_name"
        " genotyping_software_version genotype genotype_predicted_phenotype"
        " genotype_confidence_value genotyping_details genotyping_method_url".split()
    )

    PRESET = {
        "genotyping_method": b"In silico serotyping",
        "genotyping_schema_name": b"Kaptive",
        "genotyping_software_name": b"Kaptive",
        "genotyping_method_url": b"https://github.com/klebgenomics/Kaptive",
    }

    @staticmethod
    def _details_cell(result: SerotypingResult) -> bytes:
        best = b"Best locus match: %b." % result.best_locus_name.encode("utf-8")
        if not result.problems:
            return best
        notes = b", ".join(
            note(result) for flag, note in _PROBLEM_NOTES if flag in result.problems
        )
        return best[:-1] + b". Problems: " + notes

    @classmethod
    def from_result(cls, result: SerotypingResult) -> "Pha4geRow":
        taxon_cell = b"%s [NCBITaxon:%d]" % (
            result.database_organism.encode("utf-8"),
            result.database_taxon,
        )
        return cls(
            sample=result.genome.encode("utf-8"),
            genotyping_schema_taxon=taxon_cell,
            genotyping_database_name=result.database_name.encode("utf-8"),
            genotyping_database_version=result.database_version.encode("utf-8"),
            genotyping_software_version=result.kaptive_version.encode("utf-8"),
            genotype=result.best_locus_name.encode("utf-8"),
            genotype_confidence_value=_confidence_cell(result),
            genotype_predicted_phenotype=result.phenotype.encode("utf-8"),
            genotyping_details=cls._details_cell(result),
        )
