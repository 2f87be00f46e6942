r"""The serotyping engine on PyTorch: map, score, reconstruct, classify, phenotype, call.

Twin of :class:`kaptive_tpu.serotyping.core.Serotyper` with the same knobs and
decision semantics.  The mapping phase is the port's host-seeded mapper
(:mod:`kaptive_tpu_torch.ops.mapper`) and the protein-identity DP is the
port's :class:`~kaptive_tpu_torch.core.pairwise.PairwiseAligner`, both on an
explicit ``device`` (CUDA by default).  The decision phases are the JAX
package's numpy modules, reused through :mod:`kaptive_tpu_torch._reuse`, and
:meth:`Serotyper.finish_batch` is carried over line for line, so results equal
the JAX ``Serotyper``'s in host-seeded mode.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from kaptive_tpu import __version__
from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.core.interval import Intervals
from kaptive_tpu.core.seq import Sequences
from kaptive_tpu.db import Database
from kaptive_tpu.utils.profiling import phase_timer

from kaptive_tpu_torch._reuse import (
    GeneHits,
    GeneState,
    HitTable,
    LocusPieces,
    SerotypingResult,
    call_typeability,
    edge_partial_mask,
    pick_best_loci,
    reconstruct_loci,
    resolve_phenotypes,
)
from kaptive_tpu_torch.core.pairwise import PairwiseAligner
from kaptive_tpu_torch.ops.mapper import GeneIndex, MapperParams, map_genes_batch
from kaptive_tpu_torch.ops.minimizer import ContigIndex
from kaptive_tpu_torch.ops.swg import SwgLattice
from kaptive_tpu_torch.utils.device import resolve_device


def _byte_vocab(strings, pad: int = 0) -> np.ndarray:
    r"""Encode a string vocabulary as a fixed-width bytes array sized to fit."""
    encoded = [s.encode("utf-8") for s in strings]
    width = max((len(b) for b in encoded), default=1) + pad
    return np.array(encoded, dtype=f"S{max(width, 1)}")


class Serotyper:
    r"""*In silico* serotyping engine for bacterial genome assemblies on ``device``.

    ``device`` defaults to ``"cuda"`` and raises when no card is present; the
    CPU (the plain PyTorch DP) is used only when asked for.  The port builds
    its own :class:`GeneIndex` from ``db.genes`` (never ``db.gene_index``,
    which imports jax).
    """

    def __init__(
        self,
        db: Database,
        max_other_genes: int = 1,
        min_completeness: float = 0.5,
        allow_below_threshold: bool = False,
        mapper_params: MapperParams | None = None,
        min_gene_coverage: float = 0.20,
        partial_edge_tolerance: int = 5,
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self._db = db
        self.max_other_genes = max_other_genes
        self.min_completeness = min_completeness
        self.allow_below_threshold = allow_below_threshold
        self.min_gene_coverage = min_gene_coverage
        self.partial_edge_tolerance = partial_edge_tolerance
        self._gene_index = GeneIndex.build(db.genes)

        # DP bucket lattices from what this database can produce (the JAX
        # package's policy): protein pairs are bounded by the longest DB
        # protein (+25% slack), extension pairs by the longest DB gene plus
        # window padding, with a typical and a worst-case row tier.  Batch
        # 384 on CUDA and 128 on the CPU, and a protein tail batch of 96, as
        # the JAX package uses on one accelerator and on the CPU; re-deciding
        # them by measurement on the card is later work.
        dp_batch = 384 if self.device.type == "cuda" else 128
        max_prot = int(db.translations.lengths.max()) if len(db.translations) else 64
        self._protein_lattice = SwgLattice.for_max_len(
            max_prot, len_slack=max(16, max_prot // 4), batch=dp_batch, tail_batch=96,
        )
        max_gene = int(db.genes.lengths.max()) if len(db.genes) else 256
        ext_rows_typ = -(-(max_gene + 192) // 64) * 64
        ext_rows_max = -(-(max_gene + 768) // 64) * 64
        self._ext_lattice = SwgLattice.for_max_len(
            max_gene, len_slack=768, widths=(128, 512), batch=dp_batch,
            row_tiers=tuple(sorted({ext_rows_typ, ext_rows_max})),
        )
        mp = mapper_params or MapperParams()
        if mp.lattice is None:
            mp = dataclasses.replace(mp, lattice=self._ext_lattice)
        self.mapper_params = mp
        self._protein_aligner = PairwiseAligner(lattice=self._protein_lattice, device=self.device)

        self._gene_id_bytes = _byte_vocab(db.genes.ids)
        self._cluster_bytes = _byte_vocab(db.cluster_keys)
        self._descr_bytes = _byte_vocab(db.description_keys)
        # Mapper q_names convention: stringified DB gene indices.
        self._gene_names = tuple(str(i) for i in range(len(db.genes)))

    @property
    def gene_index(self) -> GeneIndex:
        return self._gene_index

    def __call__(self, genome: GenomeAssembly | str | Path) -> SerotypingResult | None:
        return self.batch([genome])[0]

    def batch(self, genomes: list[GenomeAssembly | str | Path]) -> list[SerotypingResult | None]:
        r"""Type a batch of assemblies: one extension sweep and one protein sweep."""
        assemblies, alns_list = self.map_batch(genomes)
        return self.finish_batch(assemblies, alns_list)

    def map_batch(self, genomes: list, indexes: list[ContigIndex] | None = None):
        r"""Mapping stage only: (assemblies, per-assembly Alignments).

        ``indexes`` are the assemblies' contig indexes when the caller built
        them (the streaming pipeline does, on its ingest pool, with chains
        pre-seeded); otherwise they are built here.
        """
        if len(genomes) == 0:
            return [], []
        with phase_timer("type.ingest"):
            assemblies = [GenomeAssembly.ensure(g) for g in genomes]
            if indexes is None:
                indexes = [ContigIndex.build(a.contigs) for a in assemblies]
        with phase_timer("type.map"):
            alns_list = map_genes_batch(
                self._gene_index, assemblies, self._gene_names, self.mapper_params,
                indexes=indexes, device=self.device,
            )
        return assemblies, alns_list

    def finish_batch(
        self, assemblies: list, alns_list: list
    ) -> list[SerotypingResult | None]:
        r"""Decision stages over pre-computed mapper hits (see :meth:`map_batch`)."""
        db = self._db
        n_asm = len(assemblies)
        if n_asm == 0:
            return []

        with phase_timer("type.decide"):
            table = HitTable.from_alignments(alns_list)
            pick = pick_best_loci(db, table, n_asm, self.min_gene_coverage)
            recon = reconstruct_loci(db, table, pick, n_asm)
            hits = recon.hits
            bounds = np.searchsorted(hits.asm, np.arange(n_asm + 1))
            piece_bounds = np.searchsorted(recon.piece_asm, np.arange(n_asm + 1))

        # Sequence extraction (per assembly: contigs differ) + one batched
        # translation with frame compensation and stop-codon cut.
        with phase_timer("type.extract"):
            gene_seq_parts: list[Sequences] = []
            locus_seq_parts: list[Sequences] = []
            for a, genome in enumerate(assemblies):
                rows = slice(bounds[a], bounds[a + 1])
                gene_seq_parts.append(
                    genome.contigs.extract_intervals(
                        hits.ctg[rows].astype(np.uint32),
                        _t_intervals(hits, rows),
                        new_ids=tuple(db.genes.ids[i] for i in hits.gene[rows]),
                    )
                )
                p = slice(piece_bounds[a], piece_bounds[a + 1])
                if piece_bounds[a + 1] > piece_bounds[a]:
                    locus_seq_parts.append(
                        genome.contigs.extract(
                            recon.piece_ctg[p].astype(np.int32),
                            recon.piece_lo[p].astype(np.int32),
                            recon.piece_hi[p].astype(np.int32),
                            recon.piece_orient[p],
                        )
                    )
                else:
                    locus_seq_parts.append(Sequences.empty())
            gene_seqs = Sequences.concat(gene_seq_parts)
            frames = (-hits.q_start) % 3
            prot_seqs = gene_seqs.translate(frames=frames, to_stop=True)

        # Gene states before identity: contig-edge partials, then truncation
        # below 90% translated coverage.
        partial = edge_partial_mask(hits, self.partial_edge_tolerance)
        ref_nt_len = db.genes.lengths[hits.gene]
        prot_covs = (prot_seqs.lengths * 3.0) / ref_nt_len
        states = np.where(
            partial,
            GeneState.PARTIAL.value,
            np.where(prot_covs < 0.90, GeneState.TRUNCATED.value, GeneState.NORMAL.value),
        ).astype(np.int8)
        coverages = np.clip(prot_covs * 100.0, 0.0, 100.0).astype(np.float32)

        # Protein identity DP: every hit of every assembly, one sweep.
        with phase_timer("type.protein_dp"):
            prot_alns = self._protein_aligner(prot_seqs, db.translations[hits.gene])
            pidents = prot_alns.pidents.astype(np.float32)

        with phase_timer("type.finalize"):
            # Spurious outside-locus homologies below the identity threshold
            # vanish from the result entirely.
            keep = recon.is_inside | (pidents >= db.metadata.id_threshold)
            if not keep.all():
                hits = hits.take(keep)
                gene_seqs = gene_seqs[keep]  # type: ignore[assignment]
                prot_seqs = prot_seqs[keep]  # type: ignore[assignment]
                states = states[keep]
                pidents = pidents[keep]
                coverages = coverages[keep]
                is_expected = recon.is_expected[keep]
                is_extra = recon.is_extra[keep]
                is_inside = recon.is_inside[keep]
                bounds = np.searchsorted(hits.asm, np.arange(n_asm + 1))
            else:
                is_expected, is_extra, is_inside = (
                    recon.is_expected, recon.is_extra, recon.is_inside,
                )

            # Full-length hits under the identity threshold are NOVEL.
            states[(states == GeneState.NORMAL.value) & (pidents < db.metadata.id_threshold)] = (
                GeneState.NOVEL.value
            )

            # Phenotype rules over the whole batch.
            intact = (states == GeneState.NORMAL.value) | (states == GeneState.PARTIAL.value)
            active = np.zeros((n_asm, len(db.cluster_keys)), dtype=bool)
            active[hits.asm[intact], db.gene_cluster_ids[hits.gene[intact]]] = True
            phenotypes = resolve_phenotypes(db, pick.best_locus, active)

            # Typeability.
            intruding = is_inside & ~is_expected & ~is_extra
            unexpected_counts = np.zeros(n_asm, dtype=np.int64)
            np.add.at(
                unexpected_counts,
                hits.asm[intruding & (states != GeneState.TRUNCATED.value)],
                1,
            )
            inside_novel = np.zeros(n_asm, dtype=bool)
            inside_novel[hits.asm[is_inside & (states == GeneState.NOVEL.value)]] = True
            typeable = call_typeability(
                completeness=recon.found_completeness,
                min_completeness=self.min_completeness,
                unexpected_counts=unexpected_counts,
                max_other_genes=self.max_other_genes,
                has_inside_novel=inside_novel,
                allow_below_threshold=self.allow_below_threshold,
            )

            results = [
                self._assemble_result(
                    assemblies[a], a, pick, recon, hits,
                    slice(bounds[a], bounds[a + 1]),
                    slice(piece_bounds[a], piece_bounds[a + 1]),
                    gene_seqs, prot_seqs, states, pidents, coverages,
                    is_expected, is_extra, is_inside,
                    locus_seq_parts[a], phenotypes[a], bool(typeable[a]),
                )
                for a in range(n_asm)
            ]
        return results

    def _assemble_result(
        self, genome, a, pick, recon, hits, rows, pieces,
        gene_seqs, prot_seqs, states, pidents, coverages,
        is_expected, is_extra, is_inside, locus_seqs, phenotype, typeable,
    ) -> SerotypingResult:
        db = self._db
        best = int(pick.best_locus[a])

        gene_hits = GeneHits(
            gene_indices=hits.gene[rows],
            q_starts=hits.q_start[rows],
            q_ends=hits.q_end[rows],
            t_indices=hits.ctg[rows].astype(np.uint32),
            t_starts=hits.t_start[rows],
            t_ends=hits.t_end[rows],
            strands=hits.strand[rows],
            is_expected=is_expected[rows],
            is_inside=is_inside[rows],
            is_extra=is_extra[rows],
            expected_positions=db.gene_positions[hits.gene[rows]].astype(np.int32),
            expected_strands=db.gene_intervals.strands[hits.gene[rows]],
            gene_ids=self._gene_id_bytes[hits.gene[rows]],
            cluster_names=self._cluster_bytes[db.gene_cluster_ids[hits.gene[rows]]],
            product_descriptions=self._descr_bytes[db.gene_description_ids[hits.gene[rows]]],
            coverages=coverages[rows],
        )
        locus_pieces = LocusPieces(
            ctg_indices=recon.piece_ctg[pieces].astype(np.uint32),
            starts=recon.piece_lo[pieces].astype(np.int32),
            ends=recon.piece_hi[pieces].astype(np.int32),
            strands=recon.piece_orient[pieces],
        )

        span_found = int(np.sum(recon.piece_hi[pieces] - recon.piece_lo[pieces]))
        span_ref = int(db.loci.lengths[best])
        pcov = min(100.0, span_found / span_ref * 100.0) if span_ref > 0 else 0.0
        discrepancy = float(span_found - span_ref) if len(locus_pieces) == 1 else float("nan")

        intact = pidents[rows][states[rows] == GeneState.NORMAL.value]
        pident = float(np.mean(intact)) if intact.size else 0.0

        missing = tuple(db.genes.ids[i] for i in np.flatnonzero(recon.missing_mask[a]))

        return SerotypingResult(
            kaptive_version=__version__,
            database_name=db.metadata.name,
            database_version=db.metadata.version,
            database_organism=db.metadata.organism,
            database_taxon=db.metadata.taxon,
            genome=genome.id,
            best_locus_idx=best,
            best_locus_name=db.loci.ids[best],
            best_locus_score=float(pick.raw_scores[a, best]),
            best_locus_completeness=float(recon.found_completeness[a]),
            length_discrepancy=discrepancy,
            gene_hits=gene_hits,
            gene_states=states[rows],
            locus_pieces=locus_pieces,
            locus_seqs=locus_seqs,
            gene_seqs=gene_seqs[rows],  # type: ignore[arg-type]
            translations=prot_seqs[rows],  # type: ignore[arg-type]
            percent_identity=pident,
            percent_coverage=pcov,
            protein_identities=pidents[rows],
            phenotype=phenotype,
            typeable=typeable,
            missing_expected_genes=missing,
        )


def _t_intervals(hits: HitTable, rows: slice) -> Intervals:
    return Intervals(hits.t_start[rows], hits.t_end[rows], hits.strand[rows])
