r"""In-memory SoA reference database and the GenBank+TOML compiler.

Capability parity with ``kaptive/db/core.py``: the
``Database`` container (:32-507) with the same logical fields (:82-98),
``get_locus_data`` (:100-141), ``max_locus_length`` (:143-152), load/pickle
round-trip (:242-287) and the ``from_genbank`` compiler (:289-507) including
locus/type/Extra-genes note parsing, vocabulary building, phenotype wildcard
parsing and mask construction.

The compiler here runs in two phases: GenBank records parse into per-locus
``_LocusDraft`` rows first, then the drafts flatten into the SoA arrays with
vectorised offsets/indices (``np.repeat`` instead of per-gene index loops).

Device addition: the compiled database carries a :class:`~kaptive_tpu_torch.ops.mapper.GeneIndex`
— the static hash-sorted gene minimizer table plus 2-bit encoded gene codes —
so the per-assembly mapping phase needs no DB-side preprocessing.  It is built
lazily and cached inside the pickle artifact.
"""

from __future__ import annotations

import pickle
import re
import tomllib
from collections.abc import Iterable
from dataclasses import dataclass, field
from fnmatch import filter as fnmatch_filter
from pathlib import Path
from typing import TYPE_CHECKING, Any

import numpy as np
import numpy.typing as npt

from kaptive_tpu_torch.core.collections import cumulative_offsets
from kaptive_tpu_torch.core.interval import Intervals
from kaptive_tpu_torch.core.kmers import FracMinHashIndex
from kaptive_tpu_torch.core.seq import SeqRecord, Sequences
from kaptive_tpu_torch.db.models import DatabaseError, DatabaseMetadata, Phenotype, Phenotypes

if TYPE_CHECKING:
    from kaptive_tpu_torch.compare import LocusData
    from kaptive_tpu_torch.ops.mapper import GeneIndex

# GenBank source-feature note patterns (curation format, ref db/core.py:322-324).
_NOTE_PATTERNS = {
    "locus": re.compile(r"locus:\s?(.*)$"),
    "type": re.compile(r"type:\s?(.*)$"),
    "extra": re.compile(r"Extra genes:\s?(.*)$"),
}


class _Vocab:
    r"""Insertion-ordered string -> dense id registry."""

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}

    def id_of(self, key: str) -> int:
        return self._ids.setdefault(key, len(self._ids))

    def keys(self) -> tuple[str, ...]:
        return tuple(self._ids)

    def __getitem__(self, key: str) -> int:
        return self._ids[key]

    def __len__(self) -> int:
        return len(self._ids)


@dataclass(slots=True)
class _CdsRow:
    r"""One CDS feature during compilation."""

    gene_id: str
    cluster_id: int
    description_id: int
    position: int  # 1-based within locus; 0 for extra-gene pseudo-loci
    start: int
    end: int
    strand: int


@dataclass(slots=True)
class _LocusDraft:
    r"""One parsed GenBank record before flattening."""

    name: str
    serotype: str
    is_extra: bool
    sequence: bytes
    cds: list[_CdsRow]


def _scan_notes(rec) -> tuple[str, str, bool]:
    r"""Pull (locus_name, serotype, extra?) out of the source feature's notes."""
    notes = [q.value for q in rec.features[0].qualifiers if q.key == "note"]
    if not notes:
        raise DatabaseError(f'Locus has no "note" qualifiers: {rec.name}')
    name, serotype = "", ""
    for note in notes:
        if hit := _NOTE_PATTERNS["extra"].search(note):
            return hit.group(1), "", True
        if not name and (hit := _NOTE_PATTERNS["locus"].search(note)):
            name = hit.group(1)
        if not serotype and (hit := _NOTE_PATTERNS["type"].search(note)):
            serotype = hit.group(1)
    if not name:
        raise DatabaseError(f'Locus has no valid "locus" qualifiers: {rec.name}')
    return name, serotype, False


def _first_qualifier(feat, key: str) -> str:
    for q in feat.qualifiers:
        if q.key == key:
            return q.value
    return ""


def _draft_locus(rec, clusters: _Vocab, descriptions: _Vocab) -> _LocusDraft:
    r"""Parse one GenBank record into a draft (ref ``db/core.py:344-441``)."""
    if not rec.features:
        raise DatabaseError(f"Locus has no features: {rec.name}")
    name, serotype, is_extra = _scan_notes(rec)
    draft = _LocusDraft(name, serotype, is_extra, rec.sequence.upper(), [])
    for feat in rec.features[1:]:
        if feat.kind != "CDS":
            continue
        cluster = _first_qualifier(feat, "gene")
        nth = len(draft.cds) + 1
        lo, hi = sorted((feat.location.start, feat.location.end))
        draft.cds.append(
            _CdsRow(
                gene_id=cluster if is_extra else f"{name}_{nth:02}_{cluster}",
                cluster_id=clusters.id_of(cluster),
                description_id=descriptions.id_of(_first_qualifier(feat, "product")),
                position=0 if is_extra else nth,
                start=lo,
                end=hi,
                strand=-1 if feat.location.strand in (-1, "-") else 1,
            )
        )
    return draft


def _compile_phenotypes(
    metadata: DatabaseMetadata,
    locus_names: tuple[str, ...],
    clusters: _Vocab,
) -> Phenotypes:
    r"""Wildcard-expand the TOML phenotype rules into SoA mask matrices."""
    rules = [
        Database._parse_phenotype(key, spec, locus_names, clusters.keys())
        for key, spec in metadata.phenotype_logic.items()
    ]
    locus_col = {name: i for i, name in enumerate(locus_names)}
    shape_loci = (len(rules), len(locus_names))
    shape_clusters = (len(rules), len(clusters))
    locus_masks = np.zeros(shape_loci, dtype=bool)
    extra_masks = np.zeros(shape_clusters, dtype=np.int8)
    inactive_masks = np.zeros(shape_clusters, dtype=np.int8)
    for row, rule in enumerate(rules):
        locus_masks[row, [locus_col[n] for n in rule.loci]] = True
        extra_masks[row, [clusters[n] for n in rule.extra_genes]] = 1
        inactive_masks[row, [clusters[n] for n in rule.inactive_genes]] = 1
    return Phenotypes(
        ids=np.array([r.id.encode("utf-8") for r in rules], dtype="S32"),
        locus_masks=locus_masks,
        extra_masks=extra_masks,
        inactive_masks=inactive_masks,
        extra_counts=extra_masks.sum(axis=1, dtype=np.int8),
        priorities=np.array([r.priority for r in rules], dtype=np.int8),
        as_suffix=np.array([r.as_suffix for r in rules], dtype=bool),
    )


@dataclass(frozen=True, slots=True)
class Database:
    r"""Flat SoA representation of a surface-antigen locus database."""

    metadata: DatabaseMetadata
    loci: Sequences
    serotypes: tuple[str, ...]
    locus_gene_offsets: npt.NDArray[np.uint32]
    locus_gene_lengths: npt.NDArray[np.uint32]
    gene_intervals: Intervals
    genes: Sequences
    translations: Sequences
    extra_genes: npt.NDArray[np.bool_]
    gene_locus_indices: npt.NDArray[np.uint16]
    cluster_keys: tuple[str, ...]
    gene_cluster_ids: npt.NDArray[np.uint16]
    description_keys: tuple[str, ...]
    gene_description_ids: npt.NDArray[np.uint16]
    gene_positions: npt.NDArray[np.uint16]
    phenotypes: Phenotypes
    loci_sketches: FracMinHashIndex
    _gene_index_cache: list = field(default_factory=list, repr=False, compare=False)

    @property
    def gene_index(self) -> "GeneIndex":
        r"""Lazily built, cached device mapping index over the gene set."""
        if not self._gene_index_cache:
            from kaptive_tpu_torch.ops.mapper import GeneIndex

            self._gene_index_cache.append(GeneIndex.build(self.genes))
        return self._gene_index_cache[0]

    def _locus_row(self, locus_name: str) -> int:
        return self.loci.ids.index(locus_name)

    def _gene_span(self, locus_row: int) -> slice:
        lo = int(self.locus_gene_offsets[locus_row])
        return slice(lo, lo + int(self.locus_gene_lengths[locus_row]))

    def get_locus_data(self, locus_name: str) -> "LocusData":
        r"""Locus view for comparison/plotting (ref ``db/core.py:100-141``)."""
        from kaptive_tpu_torch.compare import LocusData
        from kaptive_tpu_torch.serotyping.models import GeneState

        span = self._gene_span(self._locus_row(locus_name))
        labels = [
            key.decode("utf-8") if isinstance(key, bytes) else str(key)
            for key in (self.description_keys[i] for i in self.gene_description_ids[span])
        ]
        n = span.stop - span.start
        return LocusData(
            proteins=self.translations[span],  # type: ignore[arg-type]
            name=locus_name,
            backbone=self.gene_intervals[span],  # type: ignore[arg-type]
            pieces=None,
            gene_ctg_indices=None,
            gene_states=np.full(n, GeneState.NORMAL.value, dtype=np.int8),
            gene_descriptions=np.asarray(labels, dtype=object),
        )

    @property
    def max_locus_length(self) -> int:
        return int(self.loci.lengths.max()) if len(self.loci) else 0

    @property
    def cluster_vocab(self) -> dict[str, int]:
        return {k: i for i, k in enumerate(self.cluster_keys)}

    @property
    def description_vocab(self) -> dict[str, int]:
        return {k: i for i, k in enumerate(self.description_keys)}

    @staticmethod
    def _parse_phenotype(
        id_: str,
        data: dict[str, Any],
        locus_iterable: Iterable[str],
        cluster_iterable: Iterable[str],
    ) -> Phenotype:
        r"""Parse one phenotype rule with ``*`` wildcards (ref :182-219)."""
        picked: dict[str, list[str]] = {}
        for token, names in (
            ("loci", locus_iterable),
            ("extra_genes", cluster_iterable),
            ("inactive_genes", cluster_iterable),
        ):
            chosen = picked.setdefault(token, [])
            for pattern in data.get(token, []):
                if "*" in pattern:
                    chosen += fnmatch_filter(names, pattern)
                elif pattern in names:
                    chosen.append(pattern)
        return Phenotype(
            id_,
            set(picked["loci"]),
            set(picked["extra_genes"]),
            set(picked["inactive_genes"]),
            data.get("priority", 50),
        )

    # -- persistence -------------------------------------------------------

    @staticmethod
    def _check_file(file: str | Path, min_size: int = 1) -> Path:
        path = Path(file)
        if not (path.is_file() and path.stat().st_size >= min_size):
            raise FileNotFoundError(path)
        return path

    @classmethod
    def load(cls, file: str | Path) -> "Database":
        path = cls._check_file(file)
        loader = {".gbk": cls.from_genbank, ".pkl": cls.from_pickle}.get(path.suffix)
        if loader is None:
            raise DatabaseError(f"File {file} not supported")
        return loader(path)

    @classmethod
    def from_pickle(cls, file: str | Path) -> "Database":
        r"""Load a database pickled by this package or by the JAX package (no
        module of the latter is imported; a pickled gene index is dropped and
        rebuilt at first use)."""
        from kaptive_tpu_torch.utils.state import loads_reference

        db = loads_reference(cls._check_file(file).read_bytes())
        if not isinstance(db, cls):
            raise DatabaseError(f"{file} does not hold a Database (found {type(db).__name__})")
        return db

    def save(self, file: str | Path) -> None:
        Path(file).write_bytes(pickle.dumps(self))

    # -- the compiler ------------------------------------------------------

    @classmethod
    def from_genbank(cls, file: str | Path) -> "Database":
        r"""Compile GenBank+TOML into the flat SoA layout (ref :289-507)."""
        from kaptive_tpu_torch.db.genbank import iter_records

        path = cls._check_file(file)
        toml_path = path.with_suffix(".toml")
        if not toml_path.is_file():
            raise DatabaseError("Missing required TOML metadata file alongside Genbank file.")

        # Phase 1: parse records into drafts (loci with zero CDS are dropped).
        clusters, descriptions = _Vocab(), _Vocab()
        with path.open("rb") as fh:
            drafts = [
                d
                for d in (_draft_locus(rec, clusters, descriptions) for rec in iter_records(fh))
                if d.cds
            ]

        # Phase 2: flatten drafts into the SoA arrays.
        counts = np.array([len(d.cds) for d in drafts], dtype=np.uint32)
        all_cds = [row for d in drafts for row in d.cds]
        loci = Sequences.from_records(
            [SeqRecord(d.name, d.sequence) for d in drafts]
        )
        spans = Intervals(
            np.array([r.start for r in all_cds], dtype=np.int32),
            np.array([r.end for r in all_cds], dtype=np.int32),
            np.array([r.strand for r in all_cds], dtype=np.int8),
        )
        gene_locus_indices = np.repeat(
            np.arange(len(drafts), dtype=np.uint16), counts
        )
        genes = loci.extract_intervals(
            gene_locus_indices, spans, new_ids=tuple(r.gene_id for r in all_cds)
        )

        with toml_path.open("rb") as fp:
            metadata = DatabaseMetadata.from_dict(tomllib.load(fp))

        return cls(
            metadata=metadata,
            loci=loci,
            serotypes=tuple(d.serotype for d in drafts),
            locus_gene_offsets=cumulative_offsets(counts).astype(np.uint32),
            locus_gene_lengths=counts,
            gene_intervals=spans,
            genes=genes,
            translations=genes.translate(),
            extra_genes=np.repeat([d.is_extra for d in drafts], counts),
            gene_locus_indices=gene_locus_indices,
            cluster_keys=clusters.keys(),
            gene_cluster_ids=np.array([r.cluster_id for r in all_cds], dtype=np.uint16),
            description_keys=descriptions.keys(),
            gene_description_ids=np.array(
                [r.description_id for r in all_cds], dtype=np.uint16
            ),
            gene_positions=np.array([r.position for r in all_cds], dtype=np.uint16),
            phenotypes=_compile_phenotypes(metadata, loci.ids, clusters),
            loci_sketches=FracMinHashIndex.build(loci, sort_by_hash=False),
        )
