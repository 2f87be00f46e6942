r"""ORF prediction and database annotation for BGC analysis, on the card.

The port of ``kaptive_tpu/bgc/annotate.py`` (capability parity with
``kaptive/bgc/annotate.py``): ``Genes`` SoA (:37-120), ``AnnotationResult``
with BED export (:123-201), and ``Annotator`` (:204-343) — ORF calling (the
frameshift-tolerant gene HMM of :mod:`kaptive_tpu_torch.bgc.genefinder`, with
both strands of every contig decoded in one launch, or the six-frame scan of
:mod:`kaptive_tpu_torch.bgc.orf`, per contig on a thread pool), randstrobe
query indexing, DB top-hit search, and optional banded-SWG refinement of the
hits on the annotator's device.  Hit tallies and BED row assembly are
vectorised rather than per-gene loops.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import numpy.typing as npt

import torch

from kaptive_tpu_torch.bgc.genefinder import GeneHmmParams, find_genes_hmm_batch
from kaptive_tpu_torch.bgc.orf import find_orfs, recover_frameshifts, resolve_overlaps
from kaptive_tpu_torch.core.collections import SoAContainer, soa
from kaptive_tpu_torch.core.genome import GenomeAssembly
from kaptive_tpu_torch.core.interval import Intervals
from kaptive_tpu_torch.core.kmers import RandstrobeIndex, Seeds
from kaptive_tpu_torch.core.pairwise import PairwiseAligner, PairwiseAlignments
from kaptive_tpu_torch.core.seq import Sequences
from kaptive_tpu_torch.db import Database
from kaptive_tpu_torch.utils.device import resolve_device

_STRAND_GLYPHS = {1: "+", -1: "-"}


@dataclass(slots=True, frozen=True)
class Genes(SoAContainer):
    r"""SoA container of predicted genes: intervals, translations, contig indices.

    Batch protocol derived by :class:`~kaptive_tpu_torch.core.collections.SoAContainer`;
    integer indexing yields an ``(interval, translation, contig_index)`` tuple.
    """

    intervals: Intervals = soa(Intervals, kind="container")
    translations: Sequences = soa(Sequences, kind="container")
    contig_indices: npt.NDArray[np.uint32] = soa(np.uint32)

    def __getitem__(self, item: int | slice | npt.NDArray[Any] | list[int]) -> Any:
        if isinstance(item, (int, np.integer)):
            return (self.intervals[item], self.translations[item], self.contig_indices[item])
        # Explicit base call: slots=True dataclasses break zero-arg super().
        return SoAContainer.__getitem__(self, item)

    @classmethod
    def from_orf_calls(cls, calls_per_contig: list[list]) -> "Genes":
        r"""Flatten per-contig ORF call lists into one SoA batch."""
        rows = [(ci, orf) for ci, calls in enumerate(calls_per_contig) for orf in calls]
        n = len(rows)
        return cls(
            intervals=Intervals(
                starts=np.fromiter((o.start for _, o in rows), np.int32, n),
                ends=np.fromiter((o.end for _, o in rows), np.int32, n),
                strands=np.fromiter((o.strand for _, o in rows), np.int8, n),
            ),
            translations=Sequences.from_bytes([o.translation for _, o in rows]),
            contig_indices=np.fromiter((ci for ci, _ in rows), np.uint32, n),
        )


@dataclass(slots=True)
class AnnotationResult:
    r"""Annotation outputs: genes, query strobemer index, DB hit seeds, BED export."""

    genes: Genes
    translations_idx: RandstrobeIndex
    seeds: Seeds
    hits_mask: npt.NDArray[np.bool_]
    top_hit_names: npt.NDArray[np.object_]
    top_hit_scores: npt.NDArray[np.float32]
    contig_names: tuple[str, ...]
    alignments: PairwiseAlignments | None = None

    def _bed_rows(self, rows: npt.NDArray[np.integer]):
        r"""Yield 7-column BED lines for the selected gene rows (ref :155-201)."""
        kept = self.genes[rows]
        spans = kept.intervals
        for pos, gene_idx in enumerate(rows):
            if self.hits_mask[gene_idx]:
                tags = (
                    f"top_hit={self.top_hit_names[gene_idx]};"
                    f"score={self.top_hit_scores[gene_idx]:.2f}"
                )
            else:
                tags = "."
            yield "\t".join((
                self.contig_names[kept.contig_indices[pos]],
                str(spans.starts[pos]),
                str(spans.ends[pos]),
                str(gene_idx),
                "0",
                _STRAND_GLYPHS.get(int(spans.strands[pos]), "."),
                tags,
            )) + "\n"

    def write_bed(self, path: str | Path, hits_only: bool = True) -> None:
        r"""Write predicted genes as BED (byte-compatible with the reference)."""
        rows = (
            np.flatnonzero(self.hits_mask)
            if hits_only
            else np.arange(len(self.genes), dtype=np.int64)
        )
        with open(path, "w") as sink:
            sink.writelines(self._bed_rows(rows))


class Annotator:
    r"""ORF prediction + reference protein annotation engine on ``device``.

    ``device`` defaults to ``"cuda"`` and raises when no card is present; the
    CPU (the plain PyTorch decode and DP) is used only when asked for.  The
    aligner of ``align=True`` runs on the same device.
    """

    def __init__(self, db: Database, align: bool = False,
                 aligner_kwargs: dict[str, Any] | None = None,
                 whole_genome: bool = False, min_codons: int = 30,
                 orf_method: str = "hmm", *, device: str | torch.device = "cuda") -> None:
        r"""``orf_method``: ``"hmm"`` (default) decodes the frameshift-tolerant
        gene HMM (:mod:`kaptive_tpu_torch.bgc.genefinder`, the pyfgs/FragGeneScan
        equivalent — ref ``bgc/annotate.py:261-278``) with codon emissions
        estimated from this database's genes; ``"scan"`` uses the plain
        six-frame ORF scan with post-hoc frameshift recovery."""
        if orf_method not in ("hmm", "scan"):
            raise ValueError(f"unknown orf_method {orf_method!r}")
        self.device = resolve_device(device)
        self._db = db
        self.align = align
        self.aligner = PairwiseAligner(**(aligner_kwargs or {}), device=self.device) if align else None
        self.whole_genome = whole_genome
        self.min_codons = min_codons
        self.orf_method = orf_method
        if orf_method == "hmm":
            self._hmm_params = (
                GeneHmmParams.from_sequences(db.genes)
                if len(db.genes)
                else GeneHmmParams.uniform()
            )
        self._db_idx = RandstrobeIndex.build(self._db.translations, sort_by_hash=True)

    def _scan_orfs(self, contig: bytes) -> list:
        if len(contig) < 3:
            return []
        scanned = resolve_overlaps(find_orfs(contig, min_codons=self.min_codons))
        return recover_frameshifts(scanned)

    def _call_orfs(self, contigs: list[bytes], pool: ThreadPoolExecutor) -> list[list]:
        r"""Each contig's ORF calls, in contig order."""
        if self.orf_method == "scan":
            return list(pool.map(self._scan_orfs, contigs))
        called = find_genes_hmm_batch(
            contigs, self._hmm_params, min_codons=self.min_codons, device=self.device, pool=pool,
        )
        return [resolve_overlaps(orfs) for orfs in called]

    def _tally_top_hits(
        self, genes: Genes, seeds: Seeds
    ) -> tuple[npt.NDArray[np.bool_], npt.NDArray[np.object_], npt.NDArray[np.float32]]:
        r"""Vectorised per-gene hit mask / best DB protein name / score columns."""
        n = len(genes)
        mask = np.zeros(n, dtype=bool)
        names = np.full(n, "", dtype=object)
        scores = np.zeros(n, dtype=np.float32)
        if len(seeds):
            mask[seeds.query_indices] = True
            db_names = np.asarray(self._db.translations.ids, dtype=object)
            names[seeds.query_indices] = db_names[seeds.target_indices]
            scores[seeds.query_indices] = seeds.scores.astype(np.float32)
        return mask, names, scores

    def __call__(self, genome: GenomeAssembly) -> AnnotationResult:
        contigs = genome.contigs
        raw = [
            contigs.seqs[o : o + n].tobytes()
            for o, n in zip(contigs.offsets, contigs.lengths)
        ]
        with ThreadPoolExecutor() as pool:
            genes = Genes.from_orf_calls(self._call_orfs(raw, pool))

        query_idx = RandstrobeIndex.build(genes.translations)
        seeds = self._db_idx.top_hits(query_idx) if len(query_idx) else Seeds.empty()
        mask, names, scores = self._tally_top_hits(genes, seeds)

        alignments = None
        if self.aligner is not None and len(seeds) > 0:
            pairs = seeds.extract_sequences(genes.translations, self._db.translations)
            alignments = self.aligner(*pairs, seeds=seeds)
            scores[seeds.query_indices] = alignments.scores.astype(np.float32)

        return AnnotationResult(
            genes=genes,
            translations_idx=query_idx,
            seeds=seeds,
            hits_mask=mask,
            top_hit_names=names,
            top_hit_scores=scores,
            contig_names=contigs.ids,
            alignments=alignments,
        )
