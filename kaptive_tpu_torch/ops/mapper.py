r"""Gene-to-assembly mapper: seed, chain, extend (counterpart of :mod:`kaptive_tpu.ops.mapper`).

Two seeding modes, chosen by :func:`resolve_seed_mode` (``KAPTIVE_SEED_MODE``
or the explicit ``seed_mode=``), give the same rows:

- **Host-seeded** (the default where the native library builds): the native
  C scan in ``native/hostio.cpp`` computes each assembly's minimizers and
  matches them against the DB gene table (bloom-gated, bucketed search), or
  the numpy :func:`find_anchors` does; :func:`chain_anchors` chains them on
  the host; every chain of the batch becomes one banded SWG problem (gene vs
  projected contig window; match 2, mismatch -4, gap 4+2) in one bucketed
  sweep through :func:`kaptive_tpu_torch.core.pairwise.batched_swg_align`.
- **Device-seeded**: each assembly's 2-bit stream is uploaded (sparse form:
  the real prefix plus the positions of invalid bases), unpacked on the
  device, scanned by the row-compact minimizer scan
  (:func:`kaptive_tpu_torch.ops.scan.rowcompact_scan`, the Hopper kernel on
  CUDA), matched against the device-resident gene table
  (:func:`match_rows_batch`) and chained (:func:`chain_batch`) on the device;
  only counts and chain descriptors come back.  The extension problems are
  gathered on the device from the resident streams.  A genome that overflows
  a device buffer is seeded on the host instead, counted under
  ``map.host_fallback.<cause>``.

Results are the JAX package's :class:`~kaptive_tpu.core.alignment.Alignments`,
equal to its ``map_genes_batch(..., seed_mode=...)`` in either mode.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from kaptive_tpu.core.alignment import Alignments, Cigars
from kaptive_tpu.core.collections import cumulative_offsets, ragged_gather_indices
from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.core.pairwise import PairwiseAlignments
from kaptive_tpu.core.seq import Sequences
from kaptive_tpu.utils.metrics import count
from kaptive_tpu.utils.profiling import phase_timer

from kaptive_tpu_torch.ops.minimizer import (
    DEFAULT_K,
    DEFAULT_W,
    EXC_CAP,
    ContigIndex,
    MinimizerSet,
    build_minimizer_set,
    concat_with_sentinels,
    encode_dna,
    pack_2bit,
    pack_valid_bits,
)
from kaptive_tpu_torch.ops.scan import (
    PAD_POS,
    ROW,
    SLOTS,
    as_uint32_values,
    compact_lanes,
    rowcompact_scan,
    unpack_sparse_to_padded,
    unpack_to_padded,
)
from kaptive_tpu_torch.utils.device import resolve_device

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

# Device-seeded buffers, per genome (the JAX package's capacities; a genome
# that overflows one is seeded on the host, counted by cause).
CANDIDATE_CAP = 1 << 14  # bloom-surviving minimizers
ANCHOR_CAP = 1 << 14  # anchors
FOLD_ROWS = 16  # 128-position scan rows folded into one 1024-lane row
FOLD_SLOTS = 512  # live capacity per folded row (lambda ~ 373, P(X > 512) ~ 1e-12)
CHAIN_CAP = 4096  # chains
CHAIN_PREFIX = 512  # chain rows pulled with the counts (the full buffer past this)
_U32 = 0xFFFFFFFF
_BIG = 0x7FFFFFFF
_EXC_PAD = 0x40000000  # exception-list padding: past every stream, dropped by the unpack
_CHAIN_FIELDS = (
    "gene", "ctg", "strand", "count",
    "t_min", "t_max", "q_min", "q_max", "d_min", "d_max",
)


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
        r"""The port's index over the arrays of a JAX ``GeneIndex`` (shared, not copied).

        The host bucket starts and bloom words are shared too when the JAX
        index has built them; the port's device tables are built from these
        arrays.
        """
        ms = gene_index.minimizers
        mins = MinimizerSet(ms.hashes, ms.seq_indices, ms.positions, ms.strands, ms.n_seqs, ms.k, ms.w)
        gi = cls(mins, gene_index.codes, gene_index.starts, gene_index.lengths,
                 gene_index.k, gene_index.w)
        for key in ("buckets_np", "bloom_np"):
            if key in gene_index._cache:
                gi._cache[key] = gene_index._cache[key]
        return gi

    def _on_device(self, name: str, device: torch.device | str, make):
        key = (name, str(torch.device(device)))
        if key not in self._cache:
            self._cache[key] = make(torch.device(device))
        return self._cache[key]

    def device_table(self, device: torch.device | str):
        r"""The sorted minimizer table on ``device`` (cached): ``(hashes int64 in
        [0, 2^32), gene indices int32, positions int32, strands bool)``."""
        ms = self.minimizers

        def make(dev):
            return (
                torch.from_numpy(ms.hashes.astype(np.int64)).to(dev),
                torch.from_numpy(ms.seq_indices.astype(np.int32)).to(dev),
                torch.from_numpy(ms.positions.astype(np.int32)).to(dev),
                torch.from_numpy(ms.strands.astype(bool)).to(dev),
            )

        return self._on_device("table", device, make)

    def device_lookup(self, device: torch.device | str):
        r"""Bucketed table search on ``device`` (cached): ``(bucket starts int64,
        run length of each entry's hash int64, search steps)``.

        Searching one hash-prefix bucket takes ``ceil(log2(max occupancy + 1)) + 1``
        steps instead of a full-table binary search, and the run length gives
        the hit count without a second search.
        """

        def make(dev):
            h = self.minimizers.hashes
            occupancy = np.diff(self.host_buckets)
            iters = int(np.ceil(np.log2(max(int(occupancy.max()), 1) + 1))) + 1 if len(h) else 1
            _, inv, counts = np.unique(h, return_inverse=True, return_counts=True)
            return (
                torch.from_numpy(self.host_buckets.astype(np.int64)).to(dev),
                torch.from_numpy(counts[inv].astype(np.int64)).to(dev),
                max(iters, 1),
            )

        return self._on_device("lookup", device, make)

    def device_codes(self, device: torch.device | str) -> torch.Tensor:
        r"""The flat (sentinel-separated) gene code stream on ``device`` (cached)."""
        return self._on_device("codes", device, lambda dev: torch.from_numpy(self.codes.astype(np.uint8)).to(dev))

    def device_gene_lengths(self, device: torch.device | str) -> torch.Tensor:
        r"""Per-gene lengths on ``device`` as int64 (cached)."""
        return self._on_device(
            "glen", device, lambda dev: torch.from_numpy(self.lengths.astype(np.int64)).to(dev)
        )

    def device_bloom(self, device: torch.device | str) -> torch.Tensor:
        r""":attr:`host_bloom` on ``device`` as int32 bit patterns (cached)."""
        return self._on_device(
            "bloom", device, lambda dev: torch.from_numpy(self.host_bloom.view(np.int32).copy()).to(dev)
        )

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
    r"""Tunables for the seed-chain-extend pipeline (the JAX package's, in its field order)."""

    min_anchors: int = 2  # chains with fewer anchors are dropped
    max_diag_drift: int = 100  # single-linkage diagonal tolerance within a chain
    max_anchor_gap: int = 2000  # positional gap tolerance within a chain
    band_slack: int = 48  # extra half-band beyond the chain's diagonal spread
    window_pad: int = 64  # extra target window around the projected gene span
    min_score: int = 30  # discard extensions below this SW score
    max_occ: int = 1024  # per-contig-minimizer occurrence cap in the gene table
    emit_cigars: bool = False  # record BAM CIGARs during the extension traceback
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


def resolve_seed_mode(requested: str | None = None) -> str:
    r"""The seeding mode, ``"host"`` or ``"device"``.

    ``requested`` (or else ``KAPTIVE_SEED_MODE``) may be ``"host"``,
    ``"device"`` or ``"auto"`` (the default).  ``auto`` is host seeding when
    the native seeding library loads (the JAX package's choice on an
    accelerator) and device seeding otherwise.  Any other value raises.
    """
    mode = requested or os.environ.get("KAPTIVE_SEED_MODE", "auto")
    if mode in ("host", "device"):
        return mode
    if mode != "auto":
        raise ValueError(f"seed mode {mode!r}: expected 'host', 'device' or 'auto'")
    try:
        from kaptive_tpu.native import hostio
    except ImportError:
        return "device"
    return "host" if hasattr(hostio, "seed_anchors") else "device"


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


def _project_chains(chains: dict, gene_index: GeneIndex, contig_index: ContigIndex, params: MapperParams):
    r"""Each chain's DP problem geometry: ``(gene length, target window start,
    target window length, diagonal offset, half band)``."""
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
    return glen, t_lo, t_len, offsets, k_locals


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
    glen, t_lo, t_len, offsets, k_locals = _project_chains(chains, gene_index, contig_index, params)

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


def _run_extension_dp(
    problems: dict, lattice=None, device: str | torch.device = "cuda", emit_cigars: bool = False,
) -> tuple[PairwiseAlignments, Cigars | None]:
    r"""One batched banded-SWG sweep over concatenated extension problems:
    ``(PairwiseAlignments, Cigars or None)``, the CIGARs with ``emit_cigars``."""
    from kaptive_tpu_torch.core.pairwise import batched_swg_align, batched_swg_align_cigars

    args = (
        problems["q_codes"], problems["q_offsets"], problems["q_lengths"],
        problems["t_codes"], problems["t_offsets"], problems["t_lengths"],
        problems["offsets"], problems["k_locals"],
    )
    kw = dict(matrix=_NT_MATRIX, gap_open=NT_GAP_OPEN, gap_extend=NT_GAP_EXTEND, lattice=lattice, device=device)
    if emit_cigars:
        return batched_swg_align_cigars(*args, **kw)
    return batched_swg_align(*args, **kw), None


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
    cigars: Cigars | None = None,
) -> Alignments:
    r"""Filter/dedupe DP results and assemble the SoA alignment batch (with the
    kept rows' ``cigars`` when given)."""
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
    kept_cigars = cigars[np.flatnonzero(keep)[sel]] if cigars is not None else None

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
        cigars=kept_cigars,
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
        res, cigars_all = _run_extension_dp(
            merged, lattice=params.lattice, device=device, emit_cigars=params.emit_cigars,
        )
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
                cigars=cigars_all[sl] if cigars_all is not None else None,
            )
        )
    return results


# --- device-seeded mode ---------------------------------------------------
#
# Scan (row-compact kernel) -> match (fold, bloom gate, bucketed search,
# anchor expansion) -> chain, all on the device of the scan input, batched
# over genomes.  Every stage is fixed-capacity tensor code with no host sync;
# the counts and chain descriptors come back in one copy.


def bucketed_first_ge(table_hashes, bucket_starts, queries, iters: int):
    r"""First index in the sorted ``table_hashes`` >= each query, searching only the
    query's hash-prefix bucket (int64 hashes in ``[0, 2^32)``)."""
    T = table_hashes.shape[0]
    b = queries >> BUCKET_SHIFT
    lo = bucket_starts[b]
    hi = bucket_starts[b + 1]
    for _ in range(iters):
        mid = (lo + hi) // 2
        go = table_hashes[mid.clamp(max=T - 1)] < queries
        inside = mid < hi
        lo = torch.where(inside & go, mid + 1, lo)
        hi = torch.where(inside & ~go, mid, hi)
    return lo


def _segment_expand(cnt: torch.Tensor, cap: int):
    r"""Expand per-item counts (B, n) into ``cap`` flat slots per row.

    Returns ``(owner, within, ok, total)``: slot j belongs to item
    ``owner[j]`` as its ``within[j]``-th entry, ``ok`` marks the slots that
    hold an entry, and ``total`` (B,) is each row's entry count.  A
    scatter-max of each item's index at its start offset and a running max
    fill the owners, as the JAX package does; offsets past ``cap`` are dropped
    into a spare slot.
    """
    B, n = cnt.shape
    dev = cnt.device
    offs = cnt.cumsum(-1) - cnt
    total = offs[:, -1] + cnt[:, -1]
    start = torch.where((cnt > 0) & (offs < cap), offs, cap)
    items = torch.arange(n, device=dev).expand(B, n)
    owner = torch.zeros((B, cap + 1), dtype=torch.int64, device=dev)
    owner.scatter_reduce_(-1, start, items, reduce="amax", include_self=True)
    owner = torch.cummax(owner[:, :cap], -1).values
    j = torch.arange(cap, device=dev)
    within = j - offs.gather(-1, owner)
    ok = (j < total[:, None]) & (within >= 0) & (within < cnt.gather(-1, owner))
    return owner, within, ok, total


def match_rows_batch(
    h_rows, aux_rows, counts,
    table_hashes, table_genes, table_pos, table_strands, bucket_starts, run_len, bloom_words,
    *, cap_cand: int, cap_anchors: int, lookup_iters: int, max_occ: int,
):
    r"""Match row-compacted minimizers against the gene table (``_match_rows_core``, batched).

    ``h_rows``/``aux_rows``/``counts`` are the scan's outputs for B genomes
    (R a multiple of ``FOLD_ROWS``).  The steps: fold 16 rows into 1024 lanes
    and compact to 512; test each live slot against the bloom bitmap; compact
    the survivors; expand the rows to a flat candidate list; search each
    candidate's bucket; expand the hits to anchors.  Returns ``anchors``
    (6, B, cap_anchors) int32 with rows (valid, contig flat position, contig
    strand, gene, gene position, gene strand), and ``counts`` (4, B) int32
    with rows (minimizers, candidates, anchors, row overflow).
    """
    B, R, _ = h_rows.shape
    if R % FOLD_ROWS:
        raise ValueError(f"scan rows ({R}) must be a multiple of FOLD_ROWS ({FOLD_ROWS})")
    dev = h_rows.device
    i64 = torch.int64
    T = table_hashes.shape[0]

    # Fold: the slot's row within its fold goes to aux bits 8.. (col uses bits
    # 0-6, strand bit 7); 16 rows become one 1024-lane row, compacted to 512.
    h = as_uint32_values(h_rows)
    local = (torch.arange(R, device=dev) % FOLD_ROWS)[None, :, None]
    aux2 = aux_rows.to(i64) | (local << 8)
    Rf = R // FOLD_ROWS
    okf = (h != _U32).reshape(B, Rf, FOLD_ROWS * SLOTS)
    livef, (hq, aq), fold_cnt = compact_lanes(
        okf, (h.reshape(B, Rf, -1), aux2.reshape(B, Rf, -1)), FOLD_SLOTS
    )
    hq = torch.where(livef, hq, _U32)
    fold_overflow = (fold_cnt[..., 0] > FOLD_SLOTS).any(-1)

    bit = hq & ((1 << BLOOM_BITS) - 1)
    word = bloom_words[bit >> 5].to(i64)
    maybe = livef & (((word >> (bit & 31)) & 1) == 1)
    _, (hc, auxc), row_cnt = compact_lanes(maybe, (hq, aq), FOLD_SLOTS)

    # Folded rows -> flat candidate list.
    owner, within, ok_c, n_cand = _segment_expand(row_cnt[..., 0].to(i64), cap_cand)
    flat_idx = owner * FOLD_SLOTS + within.clamp(0, FOLD_SLOTS - 1)
    c_h = torch.where(ok_c, hc.reshape(B, -1).gather(-1, flat_idx), _U32)
    c_aux = torch.where(ok_c, auxc.reshape(B, -1).gather(-1, flat_idx), 0)
    c_pos = owner * (FOLD_ROWS * ROW) + ((c_aux >> 8) & (FOLD_ROWS - 1)) * ROW + (c_aux & (ROW - 1))
    c_strand = (c_aux >> 7) & 1

    # Bucketed search over the candidates, then candidates -> anchors.
    lo = bucketed_first_ge(table_hashes, bucket_starts, c_h, lookup_iters)
    lo_c = lo.clamp(max=T - 1)
    exact = table_hashes[lo_c] == c_h
    n_hits = torch.where(exact & (lo < T), run_len[lo_c], 0)
    cnt2 = torch.where(ok_c, n_hits.clamp(max=max_occ), 0)
    owner2, within2, ok_a, total = _segment_expand(cnt2, cap_anchors)
    ti = (lo.gather(-1, owner2) + within2).clamp(0, T - 1)

    anchors = torch.stack([
        ok_a.to(i64),
        torch.where(ok_a, c_pos.gather(-1, owner2), 0),
        c_strand.gather(-1, owner2),
        torch.where(ok_a, table_genes[ti].to(i64), 0),
        torch.where(ok_a, table_pos[ti].to(i64), 0),
        table_strands[ti].to(i64),
    ]).to(torch.int32)
    row_overflow = (counts > SLOTS).reshape(B, -1).any(-1) | fold_overflow
    out_counts = torch.stack([
        counts.to(i64).reshape(B, -1).sum(-1), n_cand, total, row_overflow.to(i64),
    ]).to(torch.int32)
    return anchors, out_counts


def chain_batch(
    anchors, match_counts, contig_starts, gene_lengths,
    *, k: int, cap_chains: int, max_diag_drift: int, max_anchor_gap: int, min_anchors: int,
):
    r"""Single-linkage chaining on the device (``_chain_core``, batched over genomes).

    ``anchors``/``match_counts`` are :func:`match_rows_batch`'s outputs,
    ``contig_starts`` (B, C) int64 each genome's contig starts padded with
    ``2^31 - 1``, ``gene_lengths`` (n_genes,) int64.  Anchors sort by (gene,
    contig, relative strand, diagonal, contig position) with stable sorts from
    the last key to the first; a chain breaks at a new group, a diagonal drift
    or a position gap; segment min/max/count reduce each chain.  Chains with
    at least ``max(min_anchors, 1)`` anchors are compacted to the front in
    chain order.  Returns ``chains`` (B, 10, cap_chains) int32 in
    ``_CHAIN_FIELDS`` order and ``counts`` (6, B) int32: ``match_counts``'
    four rows, then the raw chain count and the kept chain count.
    """
    B, cap = anchors.shape[1:]
    dev = anchors.device
    i64 = torch.int64
    valid = anchors[0] != 0
    flat_pos, c_strand, g_idx, g_pos, g_strand = (anchors[i].to(i64) for i in range(1, 6))
    c_idx = torch.searchsorted(contig_starts, flat_pos, right=True) - 1
    c_local = flat_pos - contig_starts.gather(-1, c_idx)
    rel = torch.where(g_strand == c_strand, 1, -1)
    glen = gene_lengths[g_idx]
    qp = torch.where(rel > 0, g_pos, glen - k - g_pos)
    diag = c_local - qp
    g_sort = torch.where(valid, g_idx, _BIG)

    order = torch.arange(cap, device=dev).expand(B, cap)
    for key in (c_local, diag, rel, c_idx, g_sort):  # last key first
        order = order.gather(-1, torch.sort(key.gather(-1, order), dim=-1, stable=True).indices)
    gs, cs, ss, ds, ts, qs = (x.gather(-1, order) for x in (g_sort, c_idx, rel, diag, c_local, qp))
    valid_s = gs != _BIG

    def prev(x):
        return torch.roll(x, 1, -1)

    brk = (gs != prev(gs)) | (cs != prev(cs)) | (ss != prev(ss))
    brk[:, 0] = True
    brk |= (ds - prev(ds)) > max_diag_drift
    brk |= (ts - prev(ts)).abs() > max_anchor_gap
    brk &= valid_s
    chain_id = brk.to(i64).cumsum(-1) - 1
    n_chains = brk.sum(-1)
    cid = torch.where(valid_s & (chain_id >= 0) & (chain_id < cap_chains), chain_id, cap_chains)

    def seg(x, reduce, init):
        out = torch.full((B, cap_chains + 1), init, dtype=i64, device=dev)
        return out.scatter_reduce_(-1, cid, x, reduce=reduce, include_self=True)[:, :cap_chains]

    n_anchors = torch.zeros((B, cap_chains + 1), dtype=i64, device=dev)
    n_anchors = n_anchors.scatter_add_(-1, cid, torch.ones_like(cid))[:, :cap_chains]
    out = dict(
        gene=seg(gs, "amax", -_BIG), ctg=seg(cs, "amax", -_BIG), strand=seg(ss, "amax", -_BIG),
        count=n_anchors,
        t_min=seg(ts, "amin", _BIG), t_max=seg(ts, "amax", -_BIG),
        q_min=seg(qs, "amin", _BIG), q_max=seg(qs, "amax", -_BIG),
        d_min=seg(ds, "amin", _BIG), d_max=seg(ds, "amax", -_BIG),
    )
    keep = n_anchors >= max(min_anchors, 1)
    slot = torch.where(keep, keep.to(i64).cumsum(-1) - 1, cap_chains)

    def compact(x):
        buf = torch.zeros((B, cap_chains + 1), dtype=i64, device=dev)
        return buf.scatter_(-1, slot, torch.where(keep, x, 0))[:, :cap_chains]

    chains = torch.stack([compact(out[f]) for f in _CHAIN_FIELDS], 1).to(torch.int32)
    counts = torch.cat([match_counts, n_chains[None].to(torch.int32), keep.sum(-1)[None].to(torch.int32)])
    return chains, counts


class UploadForm(NamedTuple):
    r"""One assembly's stream as uploaded for device seeding, with its contig starts.

    ``form`` is ``"sparse"`` (``mask`` = positions of invalid bases, ``real_len``
    the true stream length) or ``"dense"`` (``mask`` = bit-packed validity,
    ``real_len`` None).  The arrays are numpy on the host and tensors once
    uploaded (:func:`device_inputs`).
    """

    form: str
    packed: Any
    mask: Any
    real_len: Any
    starts: Any


def upload_form(contig_index: ContigIndex) -> UploadForm:
    r"""The assembly's host upload form (cached): sparse, the real-prefix 2-bit
    stream plus the positions of invalid bases, or dense, the whole 2-bit
    stream plus a validity bitmask, when it has more than ``EXC_CAP``
    invalid positions.

    The native stream build (``ContigIndex.build``) leaves its pack and
    exception scan in ``_cache["native_pack"]``; numpy finds the same
    exceptions without it.
    """
    cache = contig_index._cache
    if "upload_form" not in cache:
        codes, starts = contig_index.codes, contig_index.starts.astype(np.int64)
        native = cache.pop("native_pack", None)
        if native is not None:
            packed, exc, real, n_exc = native
        else:
            real = int(starts[-1] + contig_index.lengths[-1]) if len(starts) else 0
            exc = np.flatnonzero(codes[: (real + 3) // 4 * 4] >= 4).astype(np.int32)
            packed, n_exc = None, len(exc)
        if n_exc > EXC_CAP:
            form = UploadForm("dense", pack_2bit(codes), pack_valid_bits(codes), None, starts)
        else:
            if packed is None:
                packed = pack_2bit(codes[: (real + 3) // 4 * 4])
            form = UploadForm("sparse", packed, exc, np.array([real], dtype=np.int64), starts)
        cache["upload_form"] = form
    return cache["upload_form"]


def device_inputs(contig_index: ContigIndex, device: torch.device | str) -> UploadForm:
    r""":func:`upload_form` with its arrays on ``device`` (cached).

    On a card the copy runs on a side stream and this call returns once it
    has landed, so the streaming pipeline's ingest threads overlap the upload
    of the next batch with the current batch's kernels, and the mapping
    thread copies nothing from the host before its scan.  The consumer marks
    the tensors as used on its own stream (:func:`_batch_codes`), so the
    caching allocator does not reuse them under a queued kernel.
    """
    dev = torch.device(device)
    key = ("device_inputs", str(dev))
    cache = contig_index._cache
    if key not in cache:
        host = upload_form(contig_index)

        def upload(a):
            return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)

        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            with torch.cuda.stream(side):
                up = UploadForm(host.form, *(upload(a) for a in host[1:]))
            side.synchronize()
        else:
            up = UploadForm(host.form, *(upload(a) for a in host[1:]))
        cache[key] = up
    return cache[key]


def _batch_codes(indexes: list[ContigIndex], L: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Every assembly's uploaded stream unpacked into one (B, L/128 + 16, 128)
    sentinel-padded batch on ``device`` (each padded to ``L``), and the
    contig starts as (B, max contigs) int64 padded with ``2^31 - 1``.

    Only device-to-device copies: the uploads are already resident.
    """
    ups = [device_inputs(ci, device) for ci in indexes]
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for up in ups:
            for t in up[1:]:
                if t is not None:
                    t.record_stream(stream)
    n = len(ups)
    starts = torch.full((n, max(len(up.starts) for up in ups)), _BIG, dtype=torch.int64, device=device)
    for b, up in enumerate(ups):
        starts[b, : up.starts.shape[0]] = up.starts
    groups = {form: [i for i, up in enumerate(ups) if up.form == form] for form in ("sparse", "dense")}
    parts = {}
    if groups["sparse"]:
        rows = [ups[i] for i in groups["sparse"]]
        packed = torch.zeros((len(rows), max(up.packed.shape[0] for up in rows)), dtype=torch.uint8, device=device)
        exc = torch.full((len(rows), max(max(up.mask.shape[0] for up in rows), 1)), _EXC_PAD,
                         dtype=torch.int64, device=device)
        for r, up in enumerate(rows):
            packed[r, : up.packed.shape[0]] = up.packed
            exc[r, : up.mask.shape[0]] = up.mask
        real = torch.cat([up.real_len for up in rows])
        parts["sparse"] = unpack_sparse_to_padded(packed, exc, real, L)
    if groups["dense"]:
        count("map.dense_upload", len(groups["dense"]))
        rows = [ups[i] for i in groups["dense"]]
        packed = torch.zeros((len(rows), L // 4), dtype=torch.uint8, device=device)
        bits = torch.zeros((len(rows), L // 8), dtype=torch.uint8, device=device)
        for r, up in enumerate(rows):
            packed[r, : up.packed.shape[0]] = up.packed
            bits[r, : up.mask.shape[0]] = up.mask
        parts["dense"] = unpack_to_padded(packed, bits, L)
    if len(parts) == 1:
        return next(iter(parts.values())), starts
    padded = torch.empty((n, *parts["sparse"].shape[1:]), dtype=torch.uint8, device=device)
    for form, members in groups.items():
        for r, i in enumerate(members):
            padded[i] = parts[form][r]
    return padded, starts


def build_extension_specs(
    chains: dict, gene_index: GeneIndex, contig_index: ContigIndex, params: MapperParams, flat_base: int,
) -> dict | None:
    r"""Scalar-only extension specs for the device-side problem build.

    The projection of :func:`build_extension_problems` (:func:`_project_chains`),
    with no code gathered on the host: :func:`_ext_gather_bucket` gathers each bucket's query and
    target matrices on the device from the resident gene codes and padded
    genome streams.  ``flat_base`` is the genome's offset in the flattened
    (B * padded length) stream.
    """
    if len(chains["gene"]) == 0:
        return None
    glen, t_lo, t_len, offsets, k_locals = _project_chains(chains, gene_index, contig_index, params)
    t_flat = flat_base + PAD_POS + contig_index.starts[chains["ctg"]] + t_lo
    return dict(
        gene=chains["gene"], strand=chains["strand"],
        q_start=gene_index.starts[chains["gene"]].astype(np.int64),
        glen=glen.astype(np.int64), t_flat=t_flat.astype(np.int64),
        t_len=t_len, offsets=offsets.astype(np.int64),
        k_locals=k_locals.astype(np.int64), t_lo=t_lo,
    )


def _ext_gather_bucket(gene_codes, flat_codes, q_start, glen, strand, t_flat, t_len,
                       *, rows_max: int, t_cols: int, t_pad: int):
    r"""One DP bucket's (query, target) uint8 matrices, gathered on the device.

    Minus-strand queries are reverse-complemented; entries past each length
    are 0, and the target is left-padded by ``t_pad``.
    """
    dev = flat_codes.device
    j = torch.arange(rows_max, device=dev)[None, :]
    fwd = (strand > 0)[:, None]
    qi = torch.where(fwd, q_start[:, None] + j, q_start[:, None] + glen[:, None] - 1 - j)
    q = gene_codes[qi.clamp(0, gene_codes.shape[0] - 1)]
    q = torch.where(fwd | (q >= 4), q, 3 - q)
    q = torch.where(j < glen[:, None], q, 0)
    jt = torch.arange(t_cols, device=dev)[None, :]
    t = flat_codes[(t_flat[:, None] + (jt - t_pad)).clamp(0, flat_codes.shape[0] - 1)]
    t = torch.where((jt >= t_pad) & (jt < t_pad + t_len[:, None]), t, 0)
    return q.contiguous(), t.contiguous()


def launch_extension_dp_device(specs: dict, gene_index: GeneIndex, flat_codes: torch.Tensor, params: MapperParams):
    r"""Launch the bucketed banded-SWG sweep with device-side problem gathering.

    ``specs`` is the merged :func:`build_extension_specs` output and
    ``flat_codes`` the flattened padded stream batch on the device.  Bucket
    shapes follow :func:`plan_swg_buckets` with ``params.lattice``; padding
    pairs are (gene 0, length 1, band 1, empty target), as in the JAX
    package.  With ``params.emit_cigars`` each bucket runs
    :func:`~kaptive_tpu_torch.ops.swg.banded_swg_cigars` and its run buffers
    travel with the statistics; the problem build stays on the device either
    way.  Returns the pending ``(n, [(pair indices, stacked results)],
    emit_cigars)`` for :func:`collect_extension_dp_device`; nothing is copied
    back here.
    """
    from kaptive_tpu_torch.core.pairwise import run_bucket
    from kaptive_tpu_torch.ops.swg import plan_swg_buckets

    dev = flat_codes.device
    if dev.type == "cuda":
        from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix

        matrix = as_kernel_matrix(_NT_MATRIX, dev)
    else:
        matrix = torch.from_numpy(_NT_MATRIX.copy())
    gene_codes = gene_index.device_codes(dev)
    n = len(specs["gene"])
    w_needed = 2 * specs["k_locals"] + 3
    joint = np.maximum(np.maximum(specs["glen"], specs["t_len"]), 1)
    launched = []
    for sel, rows_max, w_pad, b_pad in plan_swg_buckets(joint, w_needed, params.lattice):
        t_pad = w_pad + 2
        meta = np.zeros((7, b_pad), dtype=np.int64)
        meta[[1, 2, 6]] = 1  # padding pairs: length 1, plus strand, band 1
        for row, key in enumerate(("q_start", "glen", "strand", "t_flat", "t_len", "offsets", "k_locals")):
            meta[row, : len(sel)] = specs[key][sel]
        q_start, glen, strand, t_flat, t_len, offsets, k_locals = torch.from_numpy(meta).to(dev).unbind(0)
        q_mat, t_mat = _ext_gather_bucket(
            gene_codes, flat_codes, q_start, glen, strand, t_flat, t_len,
            rows_max=rows_max, t_cols=rows_max + 2 * t_pad, t_pad=t_pad,
        )
        i32 = torch.int32
        args = (q_mat, glen.to(i32), t_mat, t_len.to(i32), offsets.to(i32), k_locals.to(i32), matrix)
        statics = dict(gap_open=NT_GAP_OPEN, gap_extend=NT_GAP_EXTEND, rows_max=rows_max, w_pad=w_pad, t_pad=t_pad)
        launched.append((sel, run_bucket(args, statics, params.emit_cigars)[:, : len(sel)]))
    return n, launched, params.emit_cigars


def collect_extension_dp_device(pending) -> tuple[PairwiseAlignments, Cigars | None]:
    r"""Bring a :func:`launch_extension_dp_device` sweep back to the host in one copy:
    ``(PairwiseAlignments, Cigars or None)``."""
    from kaptive_tpu_torch.core.pairwise import collect_buckets

    return collect_buckets(*pending)


def _map_genes_device_seeded(
    gene_index: GeneIndex, genomes: list, indexes: list,
    gene_names: tuple[str, ...], params: MapperParams, device: torch.device,
) -> list[Alignments]:
    r"""Device-seeded mapping of a batch: one scan / match / chain pass over
    every genome, one copy back of counts and chain prefixes, host checks and
    extension specs, one extension-DP sweep, one copy back of its results.

    A genome whose scan row, fold row, candidate, anchor or chain buffer
    overflowed is seeded on the host (:func:`find_anchors` + :func:`chain_anchors`),
    counted under ``map.host_fallback.<cause>`` and ``map.host_chained``; the
    others under ``map.device_chained``.  Either way its extension problems
    are gathered from the device stream.
    """
    n_genomes = len(genomes)
    k, w = gene_index.k, gene_index.w
    L = max(int(ci.codes.shape[0]) for ci in indexes)
    with phase_timer("map.pack_upload"):
        padded, starts = _batch_codes(indexes, L, device)
        flat_codes = padded.reshape(-1)
    with phase_timer("map.scan_match"):
        h, a, c = rowcompact_scan(padded, k, w)
        bucket_starts, run_len, iters = gene_index.device_lookup(device)
        anchors, match_counts = match_rows_batch(
            h, a, c, *gene_index.device_table(device), bucket_starts, run_len,
            gene_index.device_bloom(device),
            cap_cand=CANDIDATE_CAP, cap_anchors=ANCHOR_CAP, lookup_iters=iters,
            max_occ=min(params.max_occ, DEVICE_MAX_OCC),
        )
        chains_d, counts_d = chain_batch(
            anchors, match_counts, starts,
            gene_index.device_gene_lengths(device),
            k=k, cap_chains=CHAIN_CAP, max_diag_drift=params.max_diag_drift,
            max_anchor_gap=params.max_anchor_gap, min_anchors=params.min_anchors,
        )
    with phase_timer("map.scan_sync"):
        prefix = min(CHAIN_PREFIX, CHAIN_CAP)
        pulled = torch.cat([counts_d.reshape(-1), chains_d[:, :, :prefix].reshape(-1)]).cpu().numpy()
        counts_np = pulled[: counts_d.numel()].reshape(6, n_genomes).astype(np.int64)
        chains_np = pulled[counts_d.numel():].reshape(n_genomes, len(_CHAIN_FIELDS), prefix)
        n_kept = counts_np[5]
        if int(n_kept.max(initial=0)) > prefix:
            count("map.chain_prefix_miss")
            chains_np = chains_d.cpu().numpy()

    lp = L + 2 * PAD_POS  # one genome's length in the flattened padded stream
    all_chains: list[dict | None] = []
    all_specs: list[dict | None] = []
    with phase_timer("map.chain_host"):
        for b, ci in enumerate(indexes):
            causes = {
                "row_overflow": counts_np[3, b] > 0,
                "candidates": counts_np[1, b] > CANDIDATE_CAP,
                "anchors": counts_np[2, b] > ANCHOR_CAP,
                "chains": counts_np[4, b] > CHAIN_CAP,
            }
            if any(causes.values()):
                for cause, hit in causes.items():
                    if hit:
                        count(f"map.host_fallback.{cause}")
                count("map.host_chained")
                chains = chain_anchors(
                    *find_anchors(gene_index, ci.minimizers, params), gene_index.lengths, k, params
                )
            else:
                count("map.device_chained")
                arr = chains_np[b].astype(np.int64)
                chains = {f: arr[i][: n_kept[b]] for i, f in enumerate(_CHAIN_FIELDS)}
            if not chains or len(chains["gene"]) == 0:
                all_chains.append(None)
                all_specs.append(None)
                continue
            all_chains.append(chains)
            all_specs.append(build_extension_specs(chains, gene_index, ci, params, flat_base=b * lp))

    live = [s for s in all_specs if s is not None]
    if not live:
        return [Alignments.empty() for _ in range(n_genomes)]
    merged = {key: np.concatenate([s[key] for s in live]) for key in live[0] if key != "t_lo"}
    with phase_timer("map.extension_dp"):
        res, cigars_all = collect_extension_dp_device(
            launch_extension_dp_device(merged, gene_index, flat_codes, params)
        )
    bounds = np.cumsum([0] + [len(s["glen"]) if s is not None else 0 for s in all_specs])
    results: list[Alignments] = []
    for b in range(n_genomes):
        if all_specs[b] is None:
            results.append(Alignments.empty())
            continue
        sl = slice(bounds[b], bounds[b + 1])
        results.append(
            _alignments_from_extension(
                all_chains[b], res[sl], all_specs[b]["t_lo"], all_specs[b]["glen"],
                gene_index, genomes[b], indexes[b], gene_names, params,
                cigars=cigars_all[sl] if cigars_all is not None else None,
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
    r"""Map the DB gene set against a batch of assemblies on ``device``.

    ``indexes`` are the assemblies' :class:`ContigIndex` objects (built here
    when not given; the streaming pipeline builds them on its ingest pool,
    pre-seeded in host mode and pre-uploaded in device mode).  ``seed_mode``
    is resolved by :func:`resolve_seed_mode`; both modes give the same
    alignments.
    """
    mode = resolve_seed_mode(seed_mode)
    params = params or MapperParams()
    n_genomes = len(genomes)
    if n_genomes == 0:
        return []
    if indexes is None:
        indexes = [ContigIndex.build(g.contigs) for g in genomes]
    if len(gene_index.minimizers.hashes) == 0:  # empty DB gene table
        return [Alignments.empty() for _ in range(n_genomes)]
    if mode == "device":
        return _map_genes_device_seeded(gene_index, genomes, indexes, gene_names, params, resolve_device(device))
    return _map_genes_host_seeded(gene_index, genomes, indexes, gene_names, params, device)

