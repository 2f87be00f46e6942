r"""Host-seeded gene-to-assembly mapper: seed and chain on the CPU, extend on the card.

The host-seeded half of :mod:`kaptive_tpu.ops.mapper`, the mode the JAX
package takes on any accelerator:

1. **Seed** (host): the native C scan in ``native/hostio.cpp`` computes the
   assembly's minimizers and matches them against the DB gene table
   (bloom-gated, bucketed search), or the numpy :func:`find_anchors` when the
   native library cannot be built.
2. **Chain** (host): :func:`chain_anchors`, single-linkage on the diagonal.
3. **Extend** (device): every chain of every assembly in the batch becomes one
   banded SWG problem (gene vs projected contig window; match 2, mismatch -4,
   gap 4+2) in one bucketed sweep through
   :func:`kaptive_tpu_torch.core.pairwise.batched_swg_align`.

Results are the JAX package's :class:`~kaptive_tpu.core.alignment.Alignments`,
equal to ``map_genes_batch(..., seed_mode="host")`` of the JAX package.
The device-seeded mode is not ported yet (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kaptive_tpu.core.alignment import Alignments
from kaptive_tpu.core.collections import cumulative_offsets, ragged_gather_indices
from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.core.pairwise import PairwiseAlignments
from kaptive_tpu.core.seq import Sequences
from kaptive_tpu.utils.metrics import count
from kaptive_tpu.utils.profiling import phase_timer

from kaptive_tpu_torch.ops.minimizer import (
    DEFAULT_K,
    DEFAULT_W,
    ContigIndex,
    MinimizerSet,
    build_minimizer_set,
    concat_with_sentinels,
    encode_dna,
)

# Nucleotide scoring (minimap2-class defaults: match 2, mismatch -4, gap 4+2/base).
NT_MATCH = 2
NT_MISMATCH = -4
NT_GAP_OPEN = 4
NT_GAP_EXTEND = 2

_NT_MATRIX = np.full((256, 256), NT_MISMATCH, dtype=np.int32)
for _b in range(4):
    _NT_MATRIX[_b, _b] = NT_MATCH
_NT_MATRIX.flags.writeable = False

DEVICE_MAX_OCC = 1024  # ceiling on MapperParams.max_occ (the JAX package's seeding cap)
BUCKET_SHIFT = 12  # hash-prefix bucket width of the table search (2^20 buckets)
BLOOM_BITS = 27  # membership bitmap size (2^27 bits = 16 MB)


@dataclass(frozen=True, slots=True)
class GeneIndex:
    r"""Static index of the DB gene set: the hash-sorted minimizer table and gene codes."""

    minimizers: MinimizerSet  # hash-sorted over all genes
    codes: np.ndarray  # flat encoded gene sequences (with sentinels)
    starts: np.ndarray  # (n_genes,) start within codes
    lengths: np.ndarray  # (n_genes,)
    k: int
    w: int
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, genes: Sequences, k: int = DEFAULT_K, w: int = DEFAULT_W) -> GeneIndex:
        codes = encode_dna(genes.seqs)
        flat, starts = concat_with_sentinels(codes, genes.offsets, genes.lengths, k)
        mins = build_minimizer_set(genes, k=k, w=w)
        return cls(mins, flat, starts, genes.lengths.astype(np.int64), k, w)

    @classmethod
    def from_reference(cls, gene_index) -> GeneIndex:
        r"""The port's index over the arrays of a JAX ``GeneIndex`` (shared, not copied)."""
        ms = gene_index.minimizers
        mins = MinimizerSet(ms.hashes, ms.seq_indices, ms.positions, ms.strands, ms.n_seqs, ms.k, ms.w)
        return cls(mins, gene_index.codes, gene_index.starts, gene_index.lengths,
                   gene_index.k, gene_index.w)

    @property
    def host_buckets(self) -> np.ndarray:
        r"""Hash-prefix bucket starts over the sorted table (cached).

        ``buckets[hash >> BUCKET_SHIFT] .. buckets[+1]`` bounds the table run
        of any hash, so the native seeding kernel searches one bucket.
        """
        if "buckets_np" not in self._cache:
            h = self.minimizers.hashes  # sorted uint32
            n_buckets = 1 << (32 - BUCKET_SHIFT)
            bucket_of = (h >> np.uint32(BUCKET_SHIFT)).astype(np.int64)
            self._cache["buckets_np"] = np.searchsorted(
                bucket_of, np.arange(n_buckets + 1)
            ).astype(np.int32)
        return self._cache["buckets_np"]

    @property
    def host_bloom(self) -> np.ndarray:
        r"""Membership bitmap over table hashes (cached): bit ``hash & (2^BLOOM_BITS - 1)``."""
        if "bloom_np" not in self._cache:
            h = self.minimizers.hashes.astype(np.uint64)
            bit = (h & np.uint64((1 << BLOOM_BITS) - 1)).astype(np.int64)
            words = np.zeros(1 << (BLOOM_BITS - 5), dtype=np.uint32)
            np.bitwise_or.at(words, bit >> 5, np.uint32(1) << (bit & 31).astype(np.uint32))
            self._cache["bloom_np"] = words
        return self._cache["bloom_np"]


@dataclass(frozen=True, slots=True)
class MapperParams:
    r"""Tunables for the seed-chain-extend pipeline (the JAX package's, less the
    CIGAR switch: CIGAR mode is ROADMAP Queue 1, item 8)."""

    min_anchors: int = 2  # chains with fewer anchors are dropped
    max_diag_drift: int = 100  # single-linkage diagonal tolerance within a chain
    max_anchor_gap: int = 2000  # positional gap tolerance within a chain
    band_slack: int = 48  # extra half-band beyond the chain's diagonal spread
    window_pad: int = 64  # extra target window around the projected gene span
    min_score: int = 30  # discard extensions below this SW score
    max_occ: int = 1024  # per-contig-minimizer occurrence cap in the gene table
    lattice: object = None  # optional SwgLattice freezing the extension-DP shapes


def find_anchors(gene_index: GeneIndex, contig_mins: MinimizerSet, params: MapperParams):
    r"""Match contig minimizers against the sorted gene table -> anchor arrays (numpy path)."""
    h = contig_mins.hashes
    lo = np.searchsorted(gene_index.minimizers.hashes, h, side="left")
    hi = np.searchsorted(gene_index.minimizers.hashes, h, side="right")
    counts = np.minimum(hi - lo, params.max_occ)
    if counts.sum() == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z, z, z, z
    flat_idx, _, out_lengths = ragged_gather_indices(lo, counts)
    rep = np.repeat(np.arange(len(h)), out_lengths)

    g_idx = gene_index.minimizers.seq_indices[flat_idx].astype(np.int64)
    g_pos = gene_index.minimizers.positions[flat_idx].astype(np.int64)
    g_strand = gene_index.minimizers.strands[flat_idx]
    c_idx = contig_mins.seq_indices[rep].astype(np.int64)
    c_pos = contig_mins.positions[rep].astype(np.int64)
    c_strand = contig_mins.strands[rep]

    rel_strand = np.where(g_strand == c_strand, 1, -1).astype(np.int64)
    return g_idx, g_pos, c_idx, c_pos, rel_strand


def host_seed_chains(gene_index: GeneIndex, contig_index: ContigIndex, params: MapperParams) -> dict:
    r"""Anchors + chains for ONE assembly, on the host.

    Native C scan+match (:func:`kaptive_tpu.native.hostio.seed_anchors`,
    bloom-gated) when the library builds, else the numpy :func:`find_anchors`;
    both give the same anchor set.  Ingest threads call this ahead of the
    mapping phase so seeding overlaps device compute.
    """
    tm = gene_index.minimizers
    try:
        from kaptive_tpu.native import hostio
    except ImportError:  # no C++ compiler: the numpy search finds the same anchors
        count("map.host_seed.numpy")
        anchors = find_anchors(gene_index, contig_index.minimizers, params)
    else:
        ti, cpos, cstrand, _, _ = hostio.seed_anchors(
            contig_index.codes, gene_index.k, gene_index.w, tm.hashes,
            min(params.max_occ, DEVICE_MAX_OCC),
            bloom_words=gene_index.host_bloom, bloom_bits=BLOOM_BITS,
            bucket_starts=gene_index.host_buckets, bucket_shift=BUCKET_SHIFT,
        )
        count("map.host_seed.native")
        c_idx = np.searchsorted(contig_index.starts, cpos, side="right") - 1
        anchors = (
            tm.seq_indices[ti].astype(np.int64),
            tm.positions[ti].astype(np.int64),
            c_idx.astype(np.int64),
            (cpos - contig_index.starts[c_idx]).astype(np.int64),
            np.where(tm.strands[ti] == cstrand.astype(bool), 1, -1).astype(np.int64),
        )
    return chain_anchors(*anchors, gene_index.lengths, gene_index.k, params)


def chain_anchors(
    g_idx: np.ndarray,
    g_pos: np.ndarray,
    c_idx: np.ndarray,
    c_pos: np.ndarray,
    rel_strand: np.ndarray,
    gene_lengths: np.ndarray,
    k: int,
    params: MapperParams,
):
    r"""Vectorised single-linkage chaining on the alignment diagonal.

    For minus-strand anchors the gene coordinate is flipped to the
    reverse-complement frame (``q' = gene_len - k - q``) so both strands chain
    on ``diag = t_pos - q'``.
    """
    n = len(g_idx)
    if n == 0:
        return {}
    glen = gene_lengths[g_idx]
    q_prime = np.where(rel_strand > 0, g_pos, glen - k - g_pos)
    diag = c_pos - q_prime

    order = np.lexsort((c_pos, diag, rel_strand, c_idx, g_idx))
    gs, qs, cs, ts, ss, ds = (
        g_idx[order], q_prime[order], c_idx[order], c_pos[order], rel_strand[order], diag[order]
    )
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = (gs[1:] != gs[:-1]) | (cs[1:] != cs[:-1]) | (ss[1:] != ss[:-1])
    brk = new_group.copy()
    brk[1:] |= (ds[1:] - ds[:-1]) > params.max_diag_drift
    brk[1:] |= np.abs(ts[1:] - ts[:-1]) > params.max_anchor_gap
    chain_ids = np.cumsum(brk) - 1
    n_chains = chain_ids[-1] + 1

    def seg_reduce(vals, fn, init):
        out = np.full(n_chains, init, dtype=np.int64)
        fn.at(out, chain_ids, vals)
        return out

    first_of_chain = np.flatnonzero(brk)
    c_gene = gs[first_of_chain]
    c_ctg = cs[first_of_chain]
    c_strand = ss[first_of_chain]
    c_count = np.bincount(chain_ids, minlength=n_chains)
    c_tmin = seg_reduce(ts, np.minimum, np.iinfo(np.int64).max)
    c_tmax = seg_reduce(ts, np.maximum, np.iinfo(np.int64).min)
    c_qmin = seg_reduce(qs, np.minimum, np.iinfo(np.int64).max)
    c_qmax = seg_reduce(qs, np.maximum, np.iinfo(np.int64).min)
    c_dmin = seg_reduce(ds, np.minimum, np.iinfo(np.int64).max)
    c_dmax = seg_reduce(ds, np.maximum, np.iinfo(np.int64).min)

    keep = c_count >= params.min_anchors
    return {
        "gene": c_gene[keep], "ctg": c_ctg[keep], "strand": c_strand[keep],
        "count": c_count[keep], "t_min": c_tmin[keep], "t_max": c_tmax[keep],
        "q_min": c_qmin[keep], "q_max": c_qmax[keep],
        "d_min": c_dmin[keep], "d_max": c_dmax[keep],
    }


def build_extension_problems(
    chains: dict,
    gene_index: GeneIndex,
    contig_index: ContigIndex,
    params: MapperParams,
) -> dict | None:
    r"""Project chains to ragged banded-DP problems (host array assembly only)."""
    n = len(chains["gene"])
    if n == 0:
        return None

    k = gene_index.k
    glen = gene_index.lengths[chains["gene"]]
    clen = contig_index.lengths[chains["ctg"]]

    # Project the full gene onto the contig along the chain diagonals.
    t_lo = np.maximum(chains["t_min"] - chains["q_min"] - params.window_pad, 0)
    t_hi = np.minimum(
        chains["t_max"] + k + (glen - chains["q_max"] - k) + params.window_pad, clen
    )
    t_len = (t_hi - t_lo).astype(np.int64)

    # Band geometry in DP coordinates (q_pos - window_t_pos).
    d_mid = (chains["d_min"] + chains["d_max"]) // 2
    offsets = -(d_mid - t_lo)  # kernel offset convention: q_pos - t_pos
    k_locals = (chains["d_max"] - chains["d_min"]) // 2 + params.band_slack

    # Build ragged query (gene codes, revcomp for minus chains) and target windows.
    q_starts = gene_index.starts[chains["gene"]]
    fwd = chains["strand"] > 0
    base = np.where(fwd, q_starts, q_starts + glen - 1)
    steps = np.where(fwd, 1, -1)
    flat_idx, q_offsets, q_lengths = ragged_gather_indices(base, glen, steps)
    q_codes = gene_index.codes[flat_idx].astype(np.uint8)
    comp = np.repeat(~fwd, q_lengths)
    q_codes = np.where(comp & (q_codes < 4), 3 - q_codes, q_codes).astype(np.uint8)

    t_base = contig_index.starts[chains["ctg"]] + t_lo
    t_flat_idx, t_offsets, t_lengths = ragged_gather_indices(t_base, t_len)
    t_codes = contig_index.codes[t_flat_idx].astype(np.uint8)

    return dict(
        q_codes=q_codes, q_offsets=q_offsets, q_lengths=q_lengths.astype(np.int32),
        t_codes=t_codes, t_offsets=t_offsets, t_lengths=t_lengths.astype(np.int32),
        offsets=offsets.astype(np.int32), k_locals=k_locals.astype(np.int32),
        t_lo=t_lo, glen=glen,
    )


def _run_extension_dp(problems: dict, lattice=None, device: str | torch.device = "cuda") -> PairwiseAlignments:
    r"""One batched banded-SWG sweep over concatenated extension problems."""
    from kaptive_tpu_torch.core.pairwise import batched_swg_align

    return batched_swg_align(
        problems["q_codes"], problems["q_offsets"], problems["q_lengths"],
        problems["t_codes"], problems["t_offsets"], problems["t_lengths"],
        problems["offsets"], problems["k_locals"],
        matrix=_NT_MATRIX, gap_open=NT_GAP_OPEN, gap_extend=NT_GAP_EXTEND,
        lattice=lattice, device=device,
    )


def _alignments_from_extension(
    chains: dict,
    res,
    t_lo: np.ndarray,
    glen: np.ndarray,
    gene_index: GeneIndex,
    genome: GenomeAssembly,
    contig_index: ContigIndex,
    gene_names: tuple[str, ...],
    params: MapperParams,
) -> Alignments:
    r"""Filter/dedupe DP results and assemble the SoA alignment batch."""
    keep = np.asarray(res.scores) >= params.min_score
    keep &= np.asarray(res.q_ends) > np.asarray(res.q_starts)
    if not keep.any():
        return Alignments.empty()

    gene = chains["gene"][keep]
    ctg = chains["ctg"][keep]
    strand = chains["strand"][keep]
    gl = glen[keep]
    scores = np.asarray(res.scores)[keep]
    matches = np.asarray(res.matches)[keep]
    mismatches = np.asarray(res.mismatches)[keep]
    gaps = np.asarray(res.gaps)[keep]
    qs_dp = np.asarray(res.q_starts)[keep].astype(np.int64)
    qe_dp = np.asarray(res.q_ends)[keep].astype(np.int64)
    ts_dp = np.asarray(res.t_starts)[keep].astype(np.int64)
    te_dp = np.asarray(res.t_ends)[keep].astype(np.int64)
    t_lo_k = t_lo[keep]

    # Map DP coordinates back: minus-strand queries were reverse-complemented.
    fwd = strand > 0
    q_start = np.where(fwd, qs_dp, gl - qe_dp)
    q_end = np.where(fwd, qe_dp, gl - qs_dp)
    t_start = t_lo_k + ts_dp
    t_end = t_lo_k + te_dp

    # Deduplicate identical (gene, ctg, strand, t interval) hits, keeping best score.
    dedup_key = np.lexsort((-scores, t_end, t_start, strand, ctg, gene))
    gk, ck, sk = gene[dedup_key], ctg[dedup_key], strand[dedup_key]
    tsk, tek = t_start[dedup_key], t_end[dedup_key]
    uniq = np.empty(len(dedup_key), dtype=bool)
    uniq[0] = True
    uniq[1:] = (
        (gk[1:] != gk[:-1]) | (ck[1:] != ck[:-1]) | (sk[1:] != sk[:-1])
        | (tsk[1:] != tsk[:-1]) | (tek[1:] != tek[:-1])
    )
    sel = np.sort(dedup_key[uniq])

    gene, ctg, strand = gene[sel], ctg[sel], strand[sel]
    scores, matches, mismatches, gaps = scores[sel], matches[sel], mismatches[sel], gaps[sel]
    q_start, q_end, t_start, t_end = q_start[sel], q_end[sel], t_start[sel], t_end[sel]
    gl = gl[sel]

    # Primary flag + mapq (minimap2's mm_set_mapq):
    #   mapq = 60 * (1 - s2/s1) * min(1, s1/100), clipped to [0, 60]
    # where s1 is the primary score and s2 the runner-up for the same query.
    n = len(gene)
    order = np.lexsort((-scores, gene))
    is_primary = np.zeros(n, dtype=bool)
    first = np.empty(len(order), dtype=bool)
    first[0] = True
    first[1:] = gene[order][1:] != gene[order][:-1]
    is_primary[order[first]] = True
    best_per_gene = np.zeros(int(gene.max()) + 1, dtype=np.int64)
    second_per_gene = np.zeros(int(gene.max()) + 1, dtype=np.int64)
    np.maximum.at(best_per_gene, gene, scores)
    not_best = scores < best_per_gene[gene]
    np.maximum.at(second_per_gene, gene[not_best], scores[not_best])
    # An exact tie for best (repeat gene copies) means a zero runner-up margin.
    n_best = np.zeros(int(gene.max()) + 1, dtype=np.int64)
    np.add.at(n_best, gene[~not_best], 1)
    second_per_gene = np.where(n_best > 1, best_per_gene, second_per_gene)
    s1 = best_per_gene[gene].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        margin = np.where(s1 > 0, 1.0 - second_per_gene[gene] / np.maximum(s1, 1), 0.0)
    low_score_pen = np.minimum(1.0, s1 / 100.0)
    mapq = np.where(
        is_primary, np.clip(np.rint(60.0 * margin * low_score_pen), 0, 60), 0
    ).astype(np.uint8)

    edit_distance = mismatches + gaps
    # Gap-expanded per-base divergence over the aligned block.
    aligned_cols = matches + mismatches + gaps
    with np.errstate(divide="ignore", invalid="ignore"):
        divergence = np.where(
            aligned_cols > 0, (mismatches + gaps) / np.maximum(aligned_cols, 1), 0.0
        )
    return Alignments.from_arrays(
        q_name_ids=gene.astype(np.int32),
        q_names_dict=gene_names,
        q_lengths=gl.astype(np.int32),
        q_starts=q_start.astype(np.int32),
        q_ends=q_end.astype(np.int32),
        t_name_ids=ctg.astype(np.int32),
        t_names_dict=genome.contigs.ids,
        t_lengths=contig_index.lengths[ctg].astype(np.int32),
        t_starts=t_start.astype(np.int32),
        t_ends=t_end.astype(np.int32),
        strands=strand.astype(np.int8),
        matches=matches,
        edit_distances=edit_distance,
        scores=scores,
        qualities=mapq,
        block_lengths=np.maximum(q_end - q_start, t_end - t_start).astype(np.int32),
        is_primary=is_primary,
        divergence=divergence,
    )


def _map_genes_host_seeded(
    gene_index: GeneIndex, genomes: list, indexes: list,
    gene_names: tuple[str, ...], params: MapperParams, device: torch.device | str,
) -> list[Alignments]:
    r"""Host seeding and chaining, then ONE extension-DP sweep over the whole batch.

    Chains pre-seeded by the ingest pool (``ci._cache["host_chains"]``) are
    consumed only when they were seeded against this ``gene_index`` with
    these ``params``; otherwise the assembly is seeded here.
    """
    n_genomes = len(genomes)
    with phase_timer("map.host_seed"):
        all_chains: list[dict | None] = []
        for ci in indexes:
            cached = ci._cache.get("host_chains")
            chains = None
            if cached is not None:
                seed_gi, seed_params, seed_chains = cached
                if seed_gi is gene_index and seed_params == params:
                    chains = seed_chains
                    count("map.host_seed.preseeded")
            if chains is None:
                chains = host_seed_chains(gene_index, ci, params)
            all_chains.append(chains if chains and len(chains["gene"]) else None)
    with phase_timer("map.chain_host"):
        all_problems = [
            build_extension_problems(ch, gene_index, ci, params) if ch is not None else None
            for ch, ci in zip(all_chains, indexes)
        ]
    live = [p for p in all_problems if p is not None]
    if not live:
        return [Alignments.empty() for _ in range(n_genomes)]
    merged = dict(
        q_codes=np.concatenate([p["q_codes"] for p in live]),
        q_lengths=np.concatenate([p["q_lengths"] for p in live]).astype(np.int32),
        t_codes=np.concatenate([p["t_codes"] for p in live]),
        t_lengths=np.concatenate([p["t_lengths"] for p in live]).astype(np.int32),
        offsets=np.concatenate([p["offsets"] for p in live]).astype(np.int32),
        k_locals=np.concatenate([p["k_locals"] for p in live]).astype(np.int32),
    )
    merged["q_offsets"] = cumulative_offsets(merged["q_lengths"])
    merged["t_offsets"] = cumulative_offsets(merged["t_lengths"])
    with phase_timer("map.extension_dp"):
        res = _run_extension_dp(merged, lattice=params.lattice, device=device)
    counts = [len(p["q_lengths"]) if p is not None else 0 for p in all_problems]
    bounds = np.cumsum([0] + counts)
    results: list[Alignments] = []
    for b in range(n_genomes):
        if all_problems[b] is None:
            results.append(Alignments.empty())
            continue
        sl = slice(bounds[b], bounds[b + 1])
        res_b = PairwiseAlignments(
            res.scores[sl], res.matches[sl], res.mismatches[sl], res.gaps[sl],
            res.q_starts[sl], res.q_ends[sl], res.t_starts[sl], res.t_ends[sl],
        )
        results.append(
            _alignments_from_extension(
                all_chains[b], res_b, all_problems[b]["t_lo"], all_problems[b]["glen"],
                gene_index, genomes[b], indexes[b], gene_names, params,
            )
        )
    return results


def map_genes_batch(
    gene_index: GeneIndex,
    genomes: list,
    gene_names: tuple[str, ...],
    params: MapperParams | None = None,
    *,
    indexes: list[ContigIndex] | None = None,
    seed_mode: str | None = None,
    device: str | torch.device = "cuda",
) -> list[Alignments]:
    r"""Map the DB gene set against a batch of assemblies (host-seeded mode only).

    ``indexes`` are the assemblies' :class:`ContigIndex` objects (built here
    when not given; the streaming pipeline builds and pre-seeds them on its
    ingest pool).  ``seed_mode`` may be ``None``, ``"auto"`` or ``"host"``;
    ``"device"`` raises until the device-seeded slice is ported.
    """
    if seed_mode not in (None, "auto", "host"):
        raise NotImplementedError(
            f"seed_mode={seed_mode!r}: the port maps host-seeded only; device seeding "
            "is ROADMAP Queue 1, item 7 (device-seeded mapping)"
        )
    params = params or MapperParams()
    n_genomes = len(genomes)
    if n_genomes == 0:
        return []
    if indexes is None:
        indexes = [ContigIndex.build(g.contigs) for g in genomes]
    if len(gene_index.minimizers.hashes) == 0:  # empty DB gene table
        return [Alignments.empty() for _ in range(n_genomes)]
    return _map_genes_host_seeded(gene_index, genomes, indexes, gene_names, params, device)

