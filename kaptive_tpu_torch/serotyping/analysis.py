r"""Batch-vectorised typing decisions: score, reconstruct, classify, phenotype, call.

This is the decision layer between the device mapper output and the final
:class:`~kaptive_tpu_torch.serotyping.models.SerotypingResult` objects.  It matches
the *decision semantics* of the reference engine
(``kaptive/serotyping/core.py:157-459``: coverage filter,
best-hit ranking, completeness-cubed locus scoring, priority overlap culling,
spatial piece reconstruction, edge/truncation/novelty gene states, phenotype
rules and typeability) but is formulated for the batched device pipeline rather
than a per-genome pass:

- **One flat hit table** spans the whole assembly batch; every hit carries an
  assembly column, and every decision phase is a segmented vector pass over
  composite ``(asm, gene)`` / ``(asm, locus)`` / piece keys.  Nothing here
  loops over assemblies except final result-object assembly.
- **Group-leader selection** (best hit per gene, primary hit per expected
  gene) is one generic helper over composite keys instead of repeated
  sort/unique passes.
- **Piece bounding boxes, orientation votes and layout order** are segment
  reductions (``np.minimum.at`` / ``np.maximum.at`` / ``np.add.at``) keyed by
  spatial-cluster id, not per-piece Python loops.
- **Phenotype rules** evaluate as one ``rules x clusters x assemblies``
  einsum batch.

Ranking/tie-break orders are chosen to reproduce the reference's calls
hit-for-hit (see the per-function notes); dtypes follow the reference where
float rounding could leak into output formatting (float64 locus scores,
float32 completeness/coverages).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import numpy.typing as npt

from kaptive_tpu_torch.core.alignment import Alignments
from kaptive_tpu_torch.core.collections import group_leaders
from kaptive_tpu_torch.core.interval import Intervals
from kaptive_tpu_torch.utils.profiling import phase_timer

__all__ = [
    "HitTable", "LocusPick", "Reconstruction", "group_leaders",
    "pick_best_loci", "reconstruct_loci", "edge_partial_mask",
    "resolve_phenotypes", "call_typeability",
]


def _seg_min(values, keys, size, empty):
    out = np.full(size, empty, dtype=np.int64)
    np.minimum.at(out, keys, values)
    return out


def _segmented_prefix_max(values: np.ndarray, segments: np.ndarray) -> np.ndarray:
    r"""Prefix maximum within contiguous equal-``segments`` runs (log-doubling)."""
    out = values.copy()
    shift = 1
    while shift < len(out):
        carry = segments[shift:] == segments[:-shift]
        out[shift:] = np.where(carry, np.maximum(out[shift:], out[:-shift]), out[shift:])
        shift *= 2
    return out


def _overlaps_any_box(
    group: np.ndarray, start: np.ndarray, end: np.ndarray,
    box_group: np.ndarray, box_lo: np.ndarray, box_hi: np.ndarray,
) -> npt.NDArray[np.bool_]:
    r"""Per query [start, end], whether any same-group box overlaps it
    (closed-interval overlap: ``start <= box_hi and end >= box_lo``)."""
    if len(box_group) == 0 or len(group) == 0:
        return np.zeros(len(group), dtype=bool)
    order = np.lexsort((box_lo, box_group))
    bg, bl = box_group[order], box_lo[order].astype(np.int64)
    reach = _segmented_prefix_max(box_hi[order].astype(np.int64), bg)
    # Composite (group, lo) key: positions fit far below the group stride.
    stride = np.int64(max(int(bl.max(initial=0)), int(end.max(initial=0))) + 2)
    j = np.searchsorted(bg * stride + bl, group.astype(np.int64) * stride + end, side="right") - 1
    j_ok = j >= 0
    j_safe = np.maximum(j, 0)
    return j_ok & (bg[j_safe] == group) & (reach[j_safe] >= start)


def _seg_max(values, keys, size, empty):
    out = np.full(size, empty, dtype=np.int64)
    np.maximum.at(out, keys, values)
    return out


@dataclass(frozen=True, slots=True)
class HitTable:
    r"""Flat SoA table of gene-vs-assembly alignment hits across a whole batch.

    ``asm`` is the batch-position of the assembly a hit belongs to; rows are
    grouped by assembly in batch order, so per-assembly views are contiguous
    slices.  ``mapq``/``matches``/``score`` feed the ranking orders.
    """

    asm: npt.NDArray[np.int32]
    gene: npt.NDArray[np.int32]
    ctg: npt.NDArray[np.int32]
    q_start: npt.NDArray[np.int32]
    q_end: npt.NDArray[np.int32]
    t_start: npt.NDArray[np.int32]
    t_end: npt.NDArray[np.int32]
    strand: npt.NDArray[np.int8]
    score: npt.NDArray[np.int32]
    matches: npt.NDArray[np.int32]
    mapq: npt.NDArray[np.uint8]
    q_len: npt.NDArray[np.int32]  # full gene length
    t_len: npt.NDArray[np.int32]  # full contig length

    def __len__(self) -> int:
        return len(self.asm)

    def take(self, rows) -> "HitTable":
        return HitTable(
            self.asm[rows], self.gene[rows], self.ctg[rows],
            self.q_start[rows], self.q_end[rows], self.t_start[rows], self.t_end[rows],
            self.strand[rows], self.score[rows], self.matches[rows], self.mapq[rows],
            self.q_len[rows], self.t_len[rows],
        )

    @property
    def q_span(self) -> npt.NDArray[np.int32]:
        return self.q_end - self.q_start

    @property
    def q_cov(self) -> npt.NDArray[np.float64]:
        span = self.q_span
        return np.divide(
            span, self.q_len, out=np.zeros(len(span), dtype=np.float64), where=self.q_len > 0
        )

    @classmethod
    def from_alignments(cls, alns_per_asm: list[Alignments]) -> "HitTable":
        r"""Stack per-assembly mapper outputs into one batch table.

        Mapper convention: ``q_name_ids`` are DB gene indices, ``t_name_ids``
        are contig indices within each assembly (see
        :func:`kaptive_tpu_torch.ops.mapper.map_genes`).
        """
        counts = [len(a) for a in alns_per_asm]
        asm = np.repeat(np.arange(len(alns_per_asm), dtype=np.int32), counts)

        def cat(field, dtype):
            parts = [np.asarray(getattr(a, field), dtype=dtype) for a in alns_per_asm]
            return np.concatenate(parts) if parts else np.empty(0, dtype=dtype)

        return cls(
            asm=asm,
            gene=cat("q_name_ids", np.int32),
            ctg=cat("t_name_ids", np.int32),
            q_start=cat("q_starts", np.int32),
            q_end=cat("q_ends", np.int32),
            t_start=cat("t_starts", np.int32),
            t_end=cat("t_ends", np.int32),
            strand=cat("strands", np.int8),
            score=cat("scores", np.int32),
            matches=cat("matches", np.int32),
            mapq=cat("qualities", np.uint8),
            q_len=cat("q_lengths", np.int32),
            t_len=cat("t_lengths", np.int32),
        )


@dataclass(frozen=True, slots=True)
class LocusPick:
    r"""Phase-1 output: the winning locus per assembly plus reporting extras."""

    best_locus: npt.NDArray[np.int64]  # (n_asm,)
    raw_scores: npt.NDArray[np.float64]  # (n_asm, n_loci) unweighted coverage sums
    weighted_scores: npt.NDArray[np.float64]  # (n_asm, n_loci) after completeness^3
    completeness: npt.NDArray[np.float32]  # (n_asm, n_loci) matched/expected fraction
    gene_cov_total: npt.NDArray[np.float32]  # (n_asm, n_genes) summed aligned fraction


def pick_best_loci(db, hits: HitTable, n_asm: int, min_gene_coverage: float) -> LocusPick:
    r"""Phase 1 — rank candidate loci and pick one winner per assembly.

    Semantics (= ref ``serotyping/core.py:157-207``): a gene's representative
    hit is its maximum-coverage hit (ties: higher raw score, then earlier
    hit); a locus scores the sum of its expected genes' representative
    coverages, down-weighted by the cube of the fraction of expected genes
    matched at all; the per-assembly winner is the weighted argmax (first on
    ties).  Coverage totals across *all* hits per gene feed reporting.
    """
    n_genes = len(db.genes)
    n_loci = len(db.loci)

    # Reporting coverage: per (asm, gene), total aligned bases over gene length.
    gene_cov_total = np.zeros((n_asm, n_genes), dtype=np.float32)
    np.add.at(gene_cov_total, (hits.asm, hits.gene), hits.q_span)
    gene_cov_total /= np.maximum(db.genes.lengths, 1)

    raw_scores = np.zeros((n_asm, n_loci), dtype=np.float64)
    counts = np.zeros((n_asm, n_loci), dtype=np.float32)

    q_cov = hits.q_cov
    eligible = np.flatnonzero(q_cov >= min_gene_coverage)
    if len(eligible):
        sub_asm = hits.asm[eligible].astype(np.int64)
        sub_gene = hits.gene[eligible].astype(np.int64)
        composite = sub_asm * n_genes + sub_gene
        reps = group_leaders(composite, (q_cov[eligible], hits.score[eligible]))

        rep_asm = sub_asm[reps]
        rep_gene = sub_gene[reps]
        countable = ~db.extra_genes[rep_gene]  # extra genes never score a locus
        rep_locus = db.gene_locus_indices[rep_gene[countable]]
        np.add.at(raw_scores, (rep_asm[countable], rep_locus), q_cov[eligible][reps][countable])
        np.add.at(counts, (rep_asm[countable], rep_locus), 1.0)

    expected_per_locus = np.zeros(n_loci, dtype=np.float32)
    np.add.at(expected_per_locus, db.gene_locus_indices[~db.extra_genes], 1.0)
    completeness = counts / np.maximum(expected_per_locus, 1.0)

    weighted = raw_scores * (completeness**3)
    return LocusPick(
        best_locus=np.argmax(weighted, axis=1).astype(np.int64),
        raw_scores=raw_scores,
        weighted_scores=weighted,
        completeness=completeness,
        gene_cov_total=gene_cov_total,
    )


@dataclass(frozen=True, slots=True)
class Reconstruction:
    r"""Phase-2 output: the culled hit table plus piece geometry and flags."""

    hits: HitTable  # culled, still grouped by assembly
    is_expected: npt.NDArray[np.bool_]
    is_extra: npt.NDArray[np.bool_]
    is_inside: npt.NDArray[np.bool_]
    # Piece geometry, ordered by (assembly, expected-gene mean position):
    piece_asm: npt.NDArray[np.int64]
    piece_ctg: npt.NDArray[np.int64]
    piece_lo: npt.NDArray[np.int64]
    piece_hi: npt.NDArray[np.int64]
    piece_orient: npt.NDArray[np.int8]
    # Missing expected genes:
    missing_mask: npt.NDArray[np.bool_]  # (n_asm, n_genes)
    found_completeness: npt.NDArray[np.float64]  # (n_asm,)


def reconstruct_loci(db, hits: HitTable, pick: LocusPick, n_asm: int) -> Reconstruction:
    r"""Phase 2 — cull nested hits, cluster into pieces, bound the locus.

    Semantics (= ref ``serotyping/core.py:209-329``): greedy overlap culling
    in (winner-locus-first, score, matches, mapq) order within each contig;
    single-linkage clustering of surviving hits with the DB's longest-locus
    tolerance; each cluster holding a *primary* hit (the top-scoring hit of an
    expected gene) contributes a bounding piece whose extent covers its
    primary hits; orientation is the sign of the strand agreement vote; hits
    overlapping any piece box count as inside the locus.
    """
    n_genes = len(db.genes)
    hit_locus = db.gene_locus_indices[hits.gene]
    on_winner = hit_locus == pick.best_locus[hits.asm]

    # --- greedy culling.  The winner locus outranks everything; after that the
    # order is (score, matches, mapq), earliest-first on full ties.  Groups are
    # per (assembly, contig) so the batch culls in one pass.
    n_ctg_max = int(hits.ctg.max()) + 1 if len(hits) else 1
    asm_ctg = hits.asm.astype(np.int64) * n_ctg_max + hits.ctg
    visit = np.lexsort(
        (-hits.mapq.astype(np.int32), -hits.matches, -hits.score, ~on_winner)
    ).astype(np.int32)
    spans = Intervals(hits.t_start, hits.t_end, hits.strand)
    with phase_timer("decide.cull") as span:
        survived = spans.cull_overlaps(
            order=visit, max_overlap_fraction=0.1, group_by=asm_ctg, secondary_group_by=None
        )
    if span:  # counted once the span is closed, so its time is the cull's alone
        span.add("cull.items", len(spans))
        span.add("cull.kept", int(np.count_nonzero(survived)))
    hits = hits.take(survived)
    asm_ctg = asm_ctg[survived]
    n = len(hits)

    is_extra = db.extra_genes[hits.gene]
    is_expected = (db.gene_locus_indices[hits.gene] == pick.best_locus[hits.asm]) & ~is_extra

    # --- spatial pieces.
    piece_of = Intervals(hits.t_start, hits.t_end, hits.strand).cluster_spatial(
        tolerance=db.max_locus_length, group_by=asm_ctg
    )
    n_pieces = int(piece_of.max()) + 1 if n else 0

    # Primary hit per expected gene = top score, earliest on ties.
    exp_rows = np.flatnonzero(is_expected)
    primaries = exp_rows[
        group_leaders(
            hits.asm[exp_rows].astype(np.int64) * n_genes + hits.gene[exp_rows],
            (hits.score[exp_rows],),
        )
    ]

    # Piece boxes from primary hits only (segment min/max over piece ids).
    BIG = np.int64(1) << 60
    p_keys = piece_of[primaries]
    box_lo = _seg_min(hits.t_start[primaries], p_keys, n_pieces, BIG)
    box_hi = _seg_max(hits.t_end[primaries], p_keys, n_pieces, -BIG)
    n_prim = np.zeros(n_pieces, dtype=np.int64)
    np.add.at(n_prim, p_keys, 1)

    # Orientation: sign of Σ(found strand × expected strand) over primaries.
    vote = np.zeros(n_pieces, dtype=np.int64)
    np.add.at(
        vote, p_keys,
        hits.strand[primaries].astype(np.int64)
        * db.gene_intervals.strands[hits.gene[primaries]].astype(np.int64),
    )
    # Layout key: mean DB position of the piece's primary genes.
    pos_sum = np.zeros(n_pieces, dtype=np.float64)
    np.add.at(pos_sum, p_keys, db.gene_positions[hits.gene[primaries]].astype(np.float64))

    # First hit row of each piece supplies (asm, ctg) — identical across the piece.
    first_row = _seg_min(np.arange(n, dtype=np.int64), piece_of, n_pieces, BIG)

    live = n_prim > 0
    live_ids = np.flatnonzero(live)
    piece_asm = hits.asm[first_row[live_ids]].astype(np.int64)
    piece_ctg = hits.ctg[first_row[live_ids]].astype(np.int64)
    piece_lo = box_lo[live_ids]
    piece_hi = box_hi[live_ids]
    piece_orient = np.where(vote[live_ids] < 0, -1, 1).astype(np.int8)
    layout = pos_sum[live_ids] / n_prim[live_ids]
    piece_order = np.lexsort((layout, piece_asm))
    piece_asm, piece_ctg = piece_asm[piece_order], piece_ctg[piece_order]
    piece_lo, piece_hi = piece_lo[piece_order], piece_hi[piece_order]
    piece_orient = piece_orient[piece_order]

    # --- inside test: overlap any same-(asm, ctg) piece box.  Sorted-sweep
    # over (group, lo)-ordered pieces with a segmented prefix-max of hi: a hit
    # [s, e] overlaps some box of its group iff, among that group's boxes with
    # lo <= e, the largest hi is >= s.  O((P + N) log) instead of the P x N
    # per-piece pass, so batch-512 streams scale linearly.
    piece_group = piece_asm * n_ctg_max + piece_ctg
    is_inside = _overlaps_any_box(
        asm_ctg, hits.t_start, hits.t_end, piece_group, piece_lo, piece_hi
    )

    # --- missing expected genes per assembly.
    expected_mask = (
        db.gene_locus_indices[None, :] == pick.best_locus[:, None]
    ) & ~db.extra_genes[None, :]
    found_mask = np.zeros((n_asm, n_genes), dtype=bool)
    inside_expected = is_expected & is_inside
    found_mask[hits.asm[inside_expected], hits.gene[inside_expected]] = True
    missing_mask = expected_mask & ~found_mask
    n_expected = expected_mask.sum(axis=1)
    found_completeness = np.where(
        n_expected > 0, 1.0 - missing_mask.sum(axis=1) / np.maximum(n_expected, 1), 1.0
    )

    return Reconstruction(
        hits=hits,
        is_expected=is_expected,
        is_extra=is_extra,
        is_inside=is_inside,
        piece_asm=piece_asm,
        piece_ctg=piece_ctg,
        piece_lo=piece_lo,
        piece_hi=piece_hi,
        piece_orient=piece_orient,
        missing_mask=missing_mask,
        found_completeness=found_completeness,
    )


def edge_partial_mask(hits: HitTable, tolerance: int) -> npt.NDArray[np.bool_]:
    r"""Hits running off a contig edge with unaligned gene sequence beyond it.

    A hit is *left-partial* when it touches the contig start within
    ``tolerance`` while the gene end facing that edge has unaligned bases
    (head clip on ``+``, tail clip on ``-``); mirrored for right.  Equivalent
    to the reference's edge rules (``core/alignment.py:774-809``) expressed
    via clip lengths.
    """
    fwd = hits.strand == 1
    head_clip = np.where(fwd, hits.q_start, hits.q_len - hits.q_end)
    tail_clip = np.where(fwd, hits.q_len - hits.q_end, hits.q_start)
    at_left = hits.t_start <= tolerance
    at_right = hits.t_end >= hits.t_len - tolerance
    return (at_left & (head_clip > 0)) | (at_right & (tail_clip > 0))


def rule_fires(
    db, best_locus: npt.NDArray[np.int64], active_clusters: npt.NDArray[np.bool_]
) -> npt.NDArray[np.bool_]:
    r"""``(n_rules, n_asm)`` mask of the phenotype rules that fire for each assembly.

    ``active_clusters`` is an ``(n_asm, n_clusters)`` mask of gene clusters
    found intact (NORMAL/PARTIAL).  A rule fires for an assembly when (a) its
    locus pattern covers the winning locus, (b) every required extra cluster
    is active, and (c) if it names inactive clusters, at least one of those
    *expected in the winning locus* is missing/broken.
    """
    phen = db.phenotypes
    if len(phen) == 0:
        return np.zeros((0, len(best_locus)), dtype=bool)
    active8 = active_clusters.astype(np.int8)  # (n_asm, C)
    locus_ok = phen.locus_masks[:, best_locus]  # (R, n_asm)
    extras_ok = (active8 @ phen.extra_masks.T).T == phen.extra_counts[:, None]  # (R, n_asm)

    # Expected-cluster mask per assembly: one (locus x cluster) roster matrix
    # scatter-built from the DB, then a row gather by winning locus — no
    # per-assembly loop, so the phase scales with the batch linearly.
    n_clusters = active_clusters.shape[1]
    roster = np.zeros((len(db.loci), n_clusters), dtype=np.int8)
    roster[db.gene_locus_indices, db.gene_cluster_ids] = 1
    expected = roster[best_locus]  # (n_asm, C)

    names_inactive = phen.inactive_masks.sum(axis=1) > 0  # (R,)
    # applicable[r, a, c] = rule r names cluster c inactive AND c expected in a's locus
    applicable = np.einsum("rc,ac->rac", phen.inactive_masks, expected)
    broken = (1 - active8)[None, :, :]  # (1, n_asm, C)
    inactive_hit = np.einsum("rac,rac->ra", applicable, np.broadcast_to(broken, applicable.shape))
    has_applicable = applicable.sum(axis=2) > 0
    inactive_ok = ~names_inactive[:, None] | (has_applicable & (inactive_hit > 0))

    return locus_ok & extras_ok & inactive_ok


def resolve_phenotypes(
    db, best_locus: npt.NDArray[np.int64], active_clusters: npt.NDArray[np.bool_]
) -> list[str]:
    r"""Batched phenotype rule engine.

    The rules that fire (:func:`rule_fires`): firing replacement rules
    override the base type by priority; suffix rules append in descending
    priority.  (= ref ``serotyping/core.py:398-442`` +
    ``db/models.py:169-307``, evaluated for the whole batch at once.)
    """
    phen = db.phenotypes
    n_asm = len(best_locus)
    out = [db.serotypes[int(locus)] for locus in best_locus]
    if len(phen) == 0:
        return out
    fires = rule_fires(db, best_locus, active_clusters)  # (R, n_asm)

    # Replacement rules: one masked argmax-by-priority per assembly (first
    # rule wins priority ties, matching the reference's ascending-rule-id
    # argmax).  Priorities are int8 >= 0; -1 marks non-firing rules.
    NONE = np.int16(np.iinfo(np.int16).min)  # below any real (int8) priority
    override_prio = np.where(
        fires & ~phen.as_suffix[:, None], phen.priorities[:, None].astype(np.int16), NONE
    )
    winner = np.argmax(override_prio, axis=0)  # (n_asm,)
    has_override = override_prio[winner, np.arange(n_asm)] > NONE
    for a in np.flatnonzero(has_override):
        out[a] = phen.ids[winner[a]].decode("utf-8")

    # Suffix rules append in descending priority; firing suffixes are rare,
    # so only assemblies that have one enter the string-building loop.
    suffix_fires = fires & phen.as_suffix[:, None]
    for a in np.flatnonzero(suffix_fires.any(axis=0)):
        suffixes = np.flatnonzero(suffix_fires[:, a])
        by_priority = suffixes[np.argsort(-phen.priorities[suffixes])]
        out[a] += "".join(phen.ids[i].decode("utf-8") for i in by_priority)
    return out


def call_typeability(
    *,
    completeness: npt.NDArray[np.float64],
    min_completeness: float,
    unexpected_counts: npt.NDArray[np.int64],
    max_other_genes: int,
    has_inside_novel: npt.NDArray[np.bool_],
    allow_below_threshold: bool,
) -> npt.NDArray[np.bool_]:
    r"""Typeable/Untypeable per assembly (= ref ``serotyping/core.py:444-459``).

    An assembly is typeable unless the reconstructed locus is too incomplete,
    carries more intruding (non-truncated, unexpected) genes than allowed, or
    contains a below-identity-threshold gene (unless explicitly allowed).
    """
    ok = completeness >= min_completeness
    ok &= unexpected_counts <= max_other_genes
    if not allow_below_threshold:
        ok &= ~has_inside_novel
    return ok
