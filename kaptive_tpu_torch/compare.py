r"""Multi-locus comparison: all-vs-all forward protein alignment across loci.

Capability parity with ``kaptive/compare.py``:
``LocusComparisonEdges`` (:33-135), ``LocusComparisons`` (:138-169),
``LocusData`` (:172-192), ``LocusComparator`` (:195-396) — randstrobe
target/query indexes per locus and piece-aware backbone normalisation for
plotting.

Re-architected batch-first (the idiom of
:mod:`kaptive_tpu_torch.serotyping.analysis`): annotations and backbones flatten to
global tables in one pass, and the upper-triangle pair comparison collects
every pair's seeds first, then runs ONE batched device DP sweep over all of
them — the reference dispatches an aligner call per locus pair (:358-380),
which would pay a launch and a copy back per pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import TYPE_CHECKING, Sequence as SequenceType

import numpy as np
import numpy.typing as npt

from kaptive_tpu_torch.core.collections import SoAContainer, cumulative_offsets, soa
from kaptive_tpu_torch.core.interval import Intervals
from kaptive_tpu_torch.core.kmers import RandstrobeIndex, Seeds
from kaptive_tpu_torch.core.pairwise import PairwiseAligner, PairwiseAlignments
from kaptive_tpu_torch.core.seq import Sequences

if TYPE_CHECKING:
    from kaptive_tpu_torch.serotyping import LocusPieces


@dataclass(slots=True, frozen=True)
class LocusComparisonEdges(SoAContainer):
    r"""SoA container of forward cross-locus protein alignment edges.

    Batch protocol derived by :class:`~kaptive_tpu_torch.core.collections.SoAContainer`.
    """

    query_locus_indices: npt.NDArray[np.int32] = soa(np.int32)
    target_locus_indices: npt.NDArray[np.int32] = soa(np.int32)
    query_indices: npt.NDArray[np.int32] = soa(np.int32)
    target_indices: npt.NDArray[np.int32] = soa(np.int32)
    global_query_indices: npt.NDArray[np.int32] = soa(np.int32)
    global_target_indices: npt.NDArray[np.int32] = soa(np.int32)
    alignments: PairwiseAlignments = soa(PairwiseAlignments, kind="container")


@dataclass(slots=True, frozen=True)
class LocusComparisons:
    r"""Complete multi-locus comparison result set (edges + normalised intervals)."""

    edges: LocusComparisonEdges
    locus_names: tuple[str, ...]
    locus_lengths: npt.NDArray[np.int32]
    locus_offsets: npt.NDArray[np.int32]
    gene_names: npt.NDArray[np.object_]
    gene_descriptions: npt.NDArray[np.object_]
    gene_states: npt.NDArray[np.int8]
    gene_intervals: Intervals


@dataclass(slots=True, frozen=True)
class LocusData:
    r"""Generalised single-locus input for comparison (from DB or typing result)."""

    proteins: Sequences
    name: str
    backbone: Intervals
    pieces: "LocusPieces | None" = None
    gene_ctg_indices: npt.NDArray[np.uint32] | None = None
    gene_states: npt.NDArray[np.int8] | None = None
    gene_descriptions: npt.NDArray[np.object_] | SequenceType[str] | None = None


def _decode_objects(values) -> npt.NDArray[np.object_]:
    r"""Coerce a description column to a str object array (bytes -> UTF-8)."""
    arr = np.asarray(values)
    if arr.dtype.kind in ("S", "a"):
        return np.asarray(np.char.decode(arr, "utf-8"), dtype=object)
    out = np.empty(len(arr), dtype=object)
    for i, x in enumerate(arr):
        out[i] = x.decode("utf-8") if isinstance(x, (bytes, np.bytes_)) else (
            "" if x is None else str(x)
        )
    return out


class LocusComparator:
    r"""All-vs-all forward protein comparison engine over randstrobe seeding."""

    def __init__(
        self,
        k: int = 10,
        s: int = 5,
        min_score: int = 1,
        aligner_kwargs: dict | None = None,
    ) -> None:
        self.k = k
        self.s = s
        self.min_score = min_score
        self.aligner = PairwiseAligner(**(aligner_kwargs or {}))

    def __call__(self, inputs: SequenceType[LocusData]) -> LocusComparisons:
        loci = [inp.proteins for inp in inputs]
        n_loci = len(loci)
        global_seqs = Sequences.concat(loci) if n_loci else Sequences.empty()
        locus_lengths = np.array([len(x) for x in loci], dtype=np.int32)
        locus_offsets = cumulative_offsets(locus_lengths)

        gene_descriptions, gene_states = self._flatten_annotations(inputs)
        global_intervals = self._normalise_backbones(inputs)
        edges = (
            self._compare_all(loci, global_seqs, locus_offsets)
            if n_loci > 1
            else LocusComparisonEdges.empty()
        )
        return LocusComparisons(
            edges=edges,
            locus_names=tuple(inp.name for inp in inputs),
            locus_lengths=locus_lengths,
            locus_offsets=locus_offsets,
            gene_names=np.array(global_seqs.ids, dtype=object),
            gene_descriptions=gene_descriptions,
            gene_states=gene_states,
            gene_intervals=global_intervals,
        )

    def _flatten_annotations(
        self, inputs: SequenceType[LocusData]
    ) -> tuple[npt.NDArray[np.object_], npt.NDArray[np.int8]]:
        r"""Validate per-locus annotation columns and flatten to global tables."""
        from kaptive_tpu_torch.serotyping.models import GeneState

        desc_cols: list[np.ndarray] = []
        state_cols: list[np.ndarray] = []
        for inp in inputs:
            n_genes = len(inp.proteins)
            for label, col in (
                ("backbone", inp.backbone),
                ("gene_descriptions", inp.gene_descriptions),
                ("gene_states", inp.gene_states),
            ):
                if col is not None and len(col) != n_genes:
                    raise ValueError(
                        f"Locus '{inp.name}': {label} length ({len(col)}) "
                        f"does not match protein count ({n_genes})"
                    )
            desc_cols.append(
                _decode_objects(inp.gene_descriptions)
                if inp.gene_descriptions is not None
                else np.full(n_genes, "", dtype=object)
            )
            state_cols.append(
                np.asarray(inp.gene_states, dtype=np.int8)
                if inp.gene_states is not None
                else np.full(n_genes, GeneState.NORMAL.value, dtype=np.int8)
            )
        if not desc_cols:
            return np.empty(0, dtype=object), np.empty(0, dtype=np.int8)
        return (
            np.concatenate(desc_cols, dtype=object),
            np.concatenate(state_cols, dtype=np.int8),
        )

    def _normalise_backbones(self, inputs: SequenceType[LocusData]) -> Intervals:
        r"""Piece-aware backbone normalisation into one 1-D plot space per locus."""
        norm: list[Intervals] = []
        for inp in inputs:
            bb = inp.backbone
            if inp.pieces is None or len(bb) == 0:
                norm.append(bb.shift(-np.min(bb.starts)) if len(bb) > 0 else bb)
                continue
            lp = inp.pieces
            p_idx = np.zeros(len(bb), dtype=np.int32)
            for p in range(len(lp)):
                mask = (bb.starts >= lp.starts[p]) & (bb.ends <= lp.ends[p])
                if inp.gene_ctg_indices is not None:
                    mask &= inp.gene_ctg_indices == lp.ctg_indices[p]
                p_idx[mask] = p
            p_order = np.arange(len(lp), dtype=np.int32)
            norm.append(bb.arrange(p_idx, p_order, lp.starts, lp.ends, lp.strands))
        return Intervals.concat(norm) if norm else Intervals.empty()

    def _compare_all(
        self,
        loci: list[Sequences],
        global_seqs: Sequences,
        locus_offsets: npt.NDArray[np.int32],
    ) -> LocusComparisonEdges:
        r"""Seed every upper-triangle locus pair, then ONE batched DP sweep."""
        target_idx = [
            RandstrobeIndex.build(x, k=self.k, s=self.s, sort_by_hash=True) for x in loci
        ]
        query_idx = [
            RandstrobeIndex.build(x, k=self.k, s=self.s, sort_by_hash=False) for x in loci
        ]

        pair_q_locus: list[np.ndarray] = []
        pair_t_locus: list[np.ndarray] = []
        pair_seeds: list[Seeds] = []
        for i, j in combinations(range(len(loci)), 2):
            seeds = target_idx[j].top_hits(query_idx[i], min_score=self.min_score)
            if len(seeds) == 0:
                continue
            pair_q_locus.append(np.full(len(seeds), i, dtype=np.int32))
            pair_t_locus.append(np.full(len(seeds), j, dtype=np.int32))
            pair_seeds.append(seeds)
        if not pair_seeds:
            return LocusComparisonEdges.empty()

        q_locus = np.concatenate(pair_q_locus)
        t_locus = np.concatenate(pair_t_locus)
        merged = Seeds.concat(pair_seeds)
        global_q = merged.query_indices.astype(np.int32) + locus_offsets[q_locus]
        global_t = merged.target_indices.astype(np.int32) + locus_offsets[t_locus]
        # Rebase seed indices into the global protein table: one aligner call
        # covers every pair (bucketed internally by the device DP).
        global_seeds = Seeds(
            global_q.astype(np.uint32), global_t.astype(np.uint32),
            merged.scores, merged.offsets,
        )
        alignments = self.aligner.align_seeds(global_seqs, global_seqs, global_seeds)
        return LocusComparisonEdges(
            query_locus_indices=q_locus,
            target_locus_indices=t_locus,
            query_indices=merged.query_indices.astype(np.int32),
            target_indices=merged.target_indices.astype(np.int32),
            global_query_indices=global_q,
            global_target_indices=global_t,
            alignments=alignments,
        )
