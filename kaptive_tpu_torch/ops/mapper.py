r"""Gene-to-assembly mapper: seed, chain, extend (counterpart of :mod:`kaptive_tpu.ops.mapper`).

Two seeding modes, chosen by :func:`resolve_seed_mode` (``KAPTIVE_SEED_MODE``
or the explicit ``seed_mode=``; by default, device seeding on a CUDA device and
host seeding on the CPU), give the same rows:

- **Host-seeded**: the native C scan in ``csrc/hostio.cpp``
  computes each assembly's minimizers and matches them against the DB gene
  table (bloom-gated, bucketed search; the numpy :func:`find_anchors` finds
  the same anchors and is what the tests hold it to); :func:`chain_anchors` chains them on
  the host; every chain of the batch becomes one banded SWG problem (gene vs
  projected contig window; match 2, mismatch -4, gap 4+2) in one bucketed
  sweep, its scalar specs built on the host and its query and target
  matrices gathered on the device from the resident gene codes and the
  batch's uploaded 2-bit streams (:func:`_extend_on_device`).
- **Device-seeded**: each assembly's 2-bit stream is uploaded (sparse form:
  the real prefix plus the positions of invalid bases), unpacked on the
  device, scanned by the row-compact minimizer scan
  (:func:`kaptive_tpu_torch.ops.scan.rowcompact_scan`, the Hopper kernel on
  CUDA), matched against the device-resident gene table
  (:func:`match_rows_batch`) and chained (:func:`chain_batch`) on the device;
  only counts and chain descriptors come back.  The extension problems are
  gathered on the device from the resident streams.  A genome that overflows
  a device buffer is seeded on the host instead, through the native C seed
  (:func:`host_seed_chains`), counted under ``map.host_fallback.<cause>``.

Results are :class:`~kaptive_tpu_torch.core.alignment.Alignments`, equal field
for field to the JAX package's ``map_genes_batch(..., seed_mode=...)`` in either mode.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from kaptive_tpu_torch.core.alignment import Alignments, Cigars
from kaptive_tpu_torch.core.collections import ragged_gather_indices
from kaptive_tpu_torch.core.genome import GenomeAssembly
from kaptive_tpu_torch.core.pairwise import DpPairs, PairwiseAlignments, collect_buckets, launch_sweep
from kaptive_tpu_torch.core.seq import Sequences
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
from kaptive_tpu_torch.utils.device import resolve_device, sharded
from kaptive_tpu_torch.utils.metrics import count
from kaptive_tpu_torch.utils.profiling import phase_timer

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

# Device-seeded buffers, per genome; a genome that overflows one is seeded on
# the host, counted by cause.  Sized for locus databases of conserved gene
# families, whose copies in every locus all anchor on a genome's one member:
# a complete 5.3 Mb genome against 140 loci of 8 families has ~25,000 anchors,
# ~12,000 candidates and ~5,300 chains (~1,000 kept); a 4.0 Mb draft of up to
# 200 contigs against 241 loci up to ~57,000 anchors and ~8,800 chains (~2,050
# kept), which is what sets ANCHOR_CAP and CHAIN_CAP at twice that.
CANDIDATE_CAP = 1 << 15  # bloom-surviving minimizers
ANCHOR_CAP = 1 << 17  # anchors
FOLD_ROWS = 16  # 128-position scan rows folded into one 1024-lane row
FOLD_SLOTS = 512  # live capacity per folded row (lambda ~ 373, P(X > 512) ~ 1e-12)
CHAIN_CAP = 1 << 14  # chains
CHAIN_PREFIX = 4096  # kept chain rows pulled with the counts (the full buffer past this)
_U32 = 0xFFFFFFFF
_BIG = 0x7FFFFFFF
_EXC_PAD = 0x40000000  # exception-list padding: past every stream, dropped by the unpack
_CHAIN_FIELDS = (
    "gene", "ctg", "strand", "count",
    "t_min", "t_max", "q_min", "q_max", "d_min", "d_max",
)


def table_buckets(hashes: np.ndarray) -> np.ndarray:
    r"""Hash-prefix bucket starts (int32, ``2^(32 - BUCKET_SHIFT) + 1``) over a sorted uint32 hash table.

    ``buckets[hash >> BUCKET_SHIFT] .. buckets[+1]`` bounds the table run of
    any hash, so a search looks at one bucket.
    """
    bucket_of = (hashes >> np.uint32(BUCKET_SHIFT)).astype(np.int64)
    return np.searchsorted(bucket_of, np.arange((1 << (32 - BUCKET_SHIFT)) + 1)).astype(np.int32)


def table_run_lengths(hashes: np.ndarray) -> np.ndarray:
    r"""The length of each sorted table entry's hash run (int64): the hit count without a second search."""
    _, inv, counts = np.unique(hashes, return_inverse=True, return_counts=True)
    return counts[inv].astype(np.int64)


def table_bloom(hashes: np.ndarray) -> np.ndarray:
    r"""Membership bitmap (uint32 words) over table hashes: bit ``hash & (2^BLOOM_BITS - 1)``."""
    bit = (hashes.astype(np.uint64) & np.uint64((1 << BLOOM_BITS) - 1)).astype(np.int64)
    words = np.zeros(1 << (BLOOM_BITS - 5), dtype=np.uint32)
    np.bitwise_or.at(words, bit >> 5, np.uint32(1) << (bit & 31).astype(np.uint32))
    return words


def lookup_iters(buckets: np.ndarray) -> int:
    r"""Steps of the bucketed search: ``ceil(log2(max occupancy + 1)) + 1``."""
    return int(np.ceil(np.log2(max(int(np.diff(buckets).max()), 1) + 1))) + 1


class SeedTable(NamedTuple):
    r"""A gene minimizer table (or one hash-range shard of it) as :func:`match_rows_batch`
    takes it on one device, and its bucketed search's steps."""

    hashes: torch.Tensor  # int64 in [0, 2^32), sorted
    genes: torch.Tensor  # int32
    positions: torch.Tensor  # int32
    strands: torch.Tensor  # bool
    bucket_starts: torch.Tensor  # int64 (table_buckets)
    run_len: torch.Tensor  # int64 (table_run_lengths)
    bloom: torch.Tensor  # int32 bit patterns of table_bloom's words
    iters: int

    @classmethod
    def upload(cls, device, hashes, genes, positions, strands, buckets, run_len, bloom, iters: int) -> SeedTable:
        r"""Host arrays of the table to ``device`` in this layout."""

        def put(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

        return cls(
            put(hashes, np.int64), put(genes, np.int32), put(positions, np.int32), put(strands, bool),
            put(buckets, np.int64), put(run_len, np.int64), put(bloom.view(np.int32), np.int32), iters,
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

    def _on_device(self, name: str, device: torch.device | str, make):
        dev = resolve_device(device)
        key = (name, str(dev))
        if key not in self._cache:
            self._cache[key] = make(dev)
        return self._cache[key]

    def seed_table(self, device: torch.device | str = "cuda") -> SeedTable:
        r"""The whole sorted minimizer table on ``device`` (cached), as :func:`match_rows_batch` takes it."""
        ms = self.minimizers

        def make(dev):
            return SeedTable.upload(
                dev, ms.hashes, ms.seq_indices, ms.positions, ms.strands, self.host_buckets,
                table_run_lengths(ms.hashes), self.host_bloom, lookup_iters(self.host_buckets),
            )

        return self._on_device("seed_table", device, make)

    def device_table(self, device: torch.device | str = "cuda"):
        r"""``(hashes int64 in [0, 2^32), gene indices int32, positions int32, strands bool)`` on ``device``."""
        return tuple(self.seed_table(device)[:4])

    def device_lookup(self, device: torch.device | str = "cuda"):
        r"""Bucketed table search on ``device``: ``(bucket starts int64, run length of
        each entry's hash int64, search steps)``."""
        t = self.seed_table(device)
        return t.bucket_starts, t.run_len, t.iters

    def device_codes(self, device: torch.device | str = "cuda") -> torch.Tensor:
        r"""The flat (sentinel-separated) gene code stream on ``device`` (cached)."""
        return self._on_device("codes", device, lambda dev: torch.from_numpy(self.codes.astype(np.uint8)).to(dev))

    def device_gene_lengths(self, device: torch.device | str = "cuda") -> torch.Tensor:
        r"""Per-gene lengths on ``device`` as int64 (cached)."""
        return self._on_device(
            "glen", device, lambda dev: torch.from_numpy(self.lengths.astype(np.int64)).to(dev)
        )

    def device_bloom(self, device: torch.device | str = "cuda") -> torch.Tensor:
        r""":attr:`host_bloom` on ``device`` as int32 bit patterns."""
        return self.seed_table(device).bloom

    @property
    def host_buckets(self) -> np.ndarray:
        r""":func:`table_buckets` of the sorted table (cached)."""
        if "buckets_np" not in self._cache:
            self._cache["buckets_np"] = table_buckets(self.minimizers.hashes)
        return self._cache["buckets_np"]

    @property
    def host_bloom(self) -> np.ndarray:
        r""":func:`table_bloom` of the table hashes (cached)."""
        if "bloom_np" not in self._cache:
            self._cache["bloom_np"] = table_bloom(self.minimizers.hashes)
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


def resolve_seed_mode(requested: str | None = None, device: torch.device | str | None = None) -> str:
    r"""The seeding mode, ``"host"`` or ``"device"``.

    ``requested`` (or else ``KAPTIVE_SEED_MODE``) may be ``"host"``,
    ``"device"`` or ``"auto"`` (the default).  ``auto`` seeds on the card
    where ``device``, the device the batch is mapped on, is CUDA: there the
    scan kernel and the torch match and chain cost a few ms of launches a
    request against the C seed's tens of ms on one host thread.  On the CPU,
    or with no device given, ``auto`` is host seeding.  Any other value raises.
    """
    mode = requested or os.environ.get("KAPTIVE_SEED_MODE", "auto")
    if mode in ("host", "device"):
        return mode
    if mode != "auto":
        raise ValueError(f"seed mode {mode!r}: expected 'host', 'device' or 'auto'")
    return "device" if device is not None and torch.device(device).type == "cuda" else "host"


def host_seed_chains(gene_index: GeneIndex, contig_index: ContigIndex, params: MapperParams) -> dict:
    r"""Anchors + chains for ONE assembly, on the host.

    Native C scan+match (:func:`kaptive_tpu_torch.native.hostio.seed_anchors`,
    bloom-gated); the numpy :func:`find_anchors` gives the same anchor set and
    is what the tests hold it to.  Ingest threads call this ahead of the
    mapping phase so seeding overlaps device compute.
    """
    from kaptive_tpu_torch.native import hostio

    tm = gene_index.minimizers
    with phase_timer("map.seed"):
        ti, cpos, cstrand, _, _ = hostio.seed_anchors(
            contig_index.codes, gene_index.k, gene_index.w, tm.hashes,
            min(params.max_occ, DEVICE_MAX_OCC),
            bloom_words=gene_index.host_bloom, bloom_bits=BLOOM_BITS,
            bucket_starts=gene_index.host_buckets, bucket_shift=BUCKET_SHIFT,
        )
    count("map.host_seed.native")
    with phase_timer("map.chain"):
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
    r"""Project chains to ragged banded-DP problems (host array assembly only).

    The port's mapper gathers its problems on the device instead
    (:func:`build_extension_specs`); this host-built form is the reference the
    tests hold that gather to.
    """
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
    gene_names: tuple[str, ...], params: MapperParams, device: torch.device,
) -> list[Alignments]:
    r"""Host seeding and chaining, then ONE extension-DP sweep over the whole batch.

    Chains pre-seeded by the ingest pool (``ci._cache["host_chains"]``) are
    consumed only when they were seeded against this ``gene_index`` with
    these ``params``; otherwise the assembly is seeded here.  The batch's
    streams are then uploaded in their 2-bit form and the extension problems
    gathered on the device (:func:`_extend_on_device`), as in device mode.
    """
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
    L = max(int(ci.codes.shape[0]) for ci in indexes)
    with phase_timer("map.pack_upload"):
        padded, _ = _batch_codes(indexes, L, device)
    return _extend_on_device(
        all_chains, gene_index, genomes, indexes, gene_names, params, padded.reshape(-1), L + 2 * PAD_POS
    )


def _batch_alignments(
    all_chains: list, parts: list, res, cigars_all, gene_index: GeneIndex, genomes: list, indexes: list,
    gene_names: tuple[str, ...], params: MapperParams,
) -> list[Alignments]:
    r"""The batch's alignments from one sweep's results: genome ``b``'s pairs are the
    ``len(parts[b]["glen"])`` that follow the genomes before it (none where ``parts[b]``
    is None); ``parts`` are its problems or specs, which carry ``t_lo`` and ``glen``."""
    bounds = np.cumsum([0] + [len(p["glen"]) if p is not None else 0 for p in parts])
    results: list[Alignments] = []
    for b, part in enumerate(parts):
        if part is None:
            results.append(Alignments.empty())
            continue
        sl = slice(bounds[b], bounds[b + 1])
        results.append(
            _alignments_from_extension(
                all_chains[b], res[sl], part["t_lo"], part["glen"],
                gene_index, genomes[b], indexes[b], gene_names, params,
                cigars=cigars_all[sl] if cigars_all is not None else None,
            )
        )
    return results


def _extend_on_device(
    all_chains: list, gene_index: GeneIndex, genomes: list, indexes: list,
    gene_names: tuple[str, ...], params: MapperParams, flat_codes: torch.Tensor, lp: int, mesh=None,
) -> list[Alignments]:
    r"""Each genome's chains (or None) to scalar extension specs on the host, ONE
    extension-DP sweep over the whole batch with each bucket's matrices gathered
    on the device (its pair axis cut over the ``mesh`` when one is given), and the
    batch's alignments.

    ``flat_codes`` is the batch's :func:`_batch_codes` stream flattened, genome
    ``b`` at ``b * lp``; the gene codes are the resident :meth:`GeneIndex.device_codes`.
    """
    with phase_timer("map.problems") as span:
        all_specs = [
            build_extension_specs(ch, gene_index, ci, params, flat_base=b * lp) if ch is not None else None
            for b, (ch, ci) in enumerate(zip(all_chains, indexes))
        ]
        live = [s for s in all_specs if s is not None]
        if not live:
            return [Alignments.empty() for _ in genomes]
        merged = {key: np.concatenate([s[key] for s in live]) for key in live[0] if key != "t_lo"}
        n_chains = len(merged["glen"])
        count("map.problems.device", n_chains)
        if span:
            span.add("map.chains", n_chains)
    with phase_timer("map.extension_dp"):
        res, cigars_all = collect_extension_dp_device(
            launch_extension_dp_device(merged, gene_index, flat_codes, params, mesh=mesh)
        )
    with phase_timer("map.results"):
        return _batch_alignments(all_chains, all_specs, res, cigars_all, gene_index, genomes, indexes,
                                 gene_names, params)


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
    with no code gathered on the host: :func:`~kaptive_tpu_torch.core.pairwise.gather_bucket` gathers each
    bucket's query and target matrices on the device from the resident gene codes and padded
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


def run_extension_dp_device(
    specs: dict, gene_index: GeneIndex, flat_codes, params: MapperParams, *, device: str | torch.device = "cuda",
) -> PairwiseAlignments | tuple[PairwiseAlignments, Cigars]:
    r"""The bucketed banded-SWG sweep with device-side problem gathering, launched and
    collected: :func:`launch_extension_dp_device` then :func:`collect_extension_dp_device`.

    ``flat_codes`` (a tensor or a numpy array of the flattened padded stream)
    is moved to ``device`` first.  Returns the JAX package's value: the
    :class:`PairwiseAlignments`, with their ``Cigars`` beside them under
    ``params.emit_cigars``.  The streaming mapper keeps the two halves apart,
    so that one chunk's DP runs while the next chunk's chains are read.
    """
    dev = resolve_device(device)
    codes = flat_codes if isinstance(flat_codes, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(flat_codes))
    res, cigars = collect_extension_dp_device(launch_extension_dp_device(specs, gene_index, codes.to(dev), params))
    return (res, cigars) if params.emit_cigars else res


def launch_extension_dp_device(
    specs: dict, gene_index: GeneIndex, flat_codes: torch.Tensor, params: MapperParams, *, mesh=None,
):
    r"""Launch the extension DP: :func:`~kaptive_tpu_torch.core.pairwise.launch_sweep`
    over the resident gene codes and the flattened stream batch.

    ``specs`` is the merged :func:`build_extension_specs` output and
    ``flat_codes`` the flattened padded stream batch on the device.  Bucket
    shapes follow :func:`~kaptive_tpu_torch.ops.swg.plan_swg_buckets` with ``params.lattice``; with
    ``params.emit_cigars`` each bucket runs
    :func:`~kaptive_tpu_torch.ops.swg.banded_swg_cigars` and its run buffers
    travel with the statistics.  With a ``mesh`` (count-only) each bucket's pairs
    are cut over its slots.  Returns the pending sweep for
    :func:`collect_extension_dp_device`; nothing is copied back here.
    """
    dev = flat_codes.device
    pairs = DpPairs(specs["q_start"], specs["glen"], specs["strand"], specs["t_flat"], specs["t_len"],
                    specs["offsets"], specs["k_locals"])
    return launch_sweep(
        gene_index.device_codes(dev), flat_codes, pairs, matrix=_NT_MATRIX, gap_open=NT_GAP_OPEN,
        gap_extend=NT_GAP_EXTEND, lattice=params.lattice, emit_cigars=params.emit_cigars, device=dev, mesh=mesh,
    )


def collect_extension_dp_device(pending) -> tuple[PairwiseAlignments, Cigars | None]:
    r"""Bring a :func:`launch_extension_dp_device` sweep back to the host in one copy:
    ``(PairwiseAlignments, Cigars or None)``."""
    return collect_buckets(*pending)


# Bytes live for each scan slot (a 128-position row holds SLOTS of them) at the
# peak of one genome's device seeding, the fold's compaction in
# match_rows_batch: the scan's int32 hashes and aux (8), their int64 forms
# (16), the rank, slot and selected-value temporaries of compact_lanes (24),
# its two int64 outputs at half width (8), the bool masks and the broadcast
# row index (~10).
_SLOT_BYTES = 66
# Bytes for each slot of the fixed-capacity candidate list: the ~20 int64
# columns of the flat expansion and the bucketed search.
_ENTRY_BYTES = 160
# Bytes for each anchor slot of one table shard at chaining: the matched
# anchors and their concatenation over shards, the ~20 int64 columns that the
# five sorts and the chain breaks keep at once, the segment ids (~240: a chunk
# of 2 genomes against 2 shards peaked at 124.6 MB over 2 x 2 x 131,072 slots,
# NVIDIA H100).
_ANCHOR_BYTES = 240


def genome_footprint(L: int, shards: int = 1) -> int:
    r"""Device bytes that scan, match and chain need for one genome of padded stream length ``L``,
    matched against a table cut into ``shards`` (whose anchors are chained together)."""
    rows = (L + 2 * PAD_POS) // ROW
    return (rows * (ROW + SLOTS * _SLOT_BYTES) + CANDIDATE_CAP * _ENTRY_BYTES
            + shards * ANCHOR_CAP * _ANCHOR_BYTES)


def seeding_chunk(L: int, n_genomes: int, device: torch.device, slots: int = 1, shards: int = 1) -> int:
    r"""Genomes a device-seeding chunk holds: half the card's free memory, shared
    by the ``slots`` mesh slots placed on the card, over :func:`genome_footprint`
    against ``shards`` table shards, at least 1; the whole batch on the CPU.

    The other half is left for the flattened stream of the batch, the
    extension DP and the caching allocator's slack.
    """
    if device.type != "cuda":
        return max(n_genomes, 1)
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(n_genomes, free // 2 // slots // genome_footprint(L, shards)))


def _overflows(counts: np.ndarray) -> dict[str, np.ndarray]:
    r"""Each fallback cause's (B,) mask over :func:`chain_batch`'s ``counts`` (6, B) on the host."""
    return {
        "row_overflow": counts[3] > 0,
        "candidates": counts[1] > CANDIDATE_CAP,
        "anchors": counts[2] > ANCHOR_CAP,
        "chains": counts[4] > CHAIN_CAP,
    }


def _device_chains(counts: np.ndarray, chains: np.ndarray, b: int, contig_index: ContigIndex,
                   gene_index: GeneIndex, params: MapperParams) -> dict:
    r"""Genome ``b``'s chains from :func:`chain_batch`'s ``counts`` (6, B) and
    ``chains`` (B, 10, n) pulled to the host.

    A genome whose scan row, fold row, candidate, anchor or chain buffer
    overflowed is seeded on the host instead, through the native C seed
    (:func:`host_seed_chains`: the same anchors, so the same chains), counted
    under ``map.host_fallback.<cause>`` and ``map.host_chained``; the others
    under ``map.device_chained``.
    """
    causes = [cause for cause, hit in _overflows(counts[:, b : b + 1]).items() if hit[0]]
    if causes:
        for cause in causes:
            count(f"map.host_fallback.{cause}")
        count("map.host_chained")
        return host_seed_chains(gene_index, contig_index, params)
    count("map.device_chained")
    arr = chains[b].astype(np.int64)
    return {f: arr[i][: counts[5, b]] for i, f in enumerate(_CHAIN_FIELDS)}


def seed_chunk(codes: torch.Tensor, starts: torch.Tensor, shards: list, gene_index: GeneIndex,
               params: MapperParams) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Scan, match and chain one chunk of genomes against a gene table cut into ``shards``.

    ``codes`` (n, R * 128 + halo) uint8 and ``starts`` are the chunk's
    :func:`_batch_codes` on its home device.  ``shards`` lists ``(device,
    SeedTable)``: the whole table on the home device, or a mesh row's table
    shards (:class:`~kaptive_tpu_torch.parallel.typing.ShardedGeneTable`).
    The chunk is scanned once on each distinct device of ``shards`` and
    matched against each shard; the shards' anchor sets are disjoint, so their
    anchors are concatenated in shard order on the home device and chained
    there (chaining sorts on composite keys and masks on ``valid``).  The
    match counts are the maxima over shards (each shard holds the caps on its
    own) and the OR of the row-overflow flags.  Returns :func:`chain_batch`'s
    ``(chains, counts)`` on the home device.
    """
    home = codes.device
    scans: dict[torch.device, tuple] = {}
    anchors, counts = [], []
    for dev, table in shards:
        if dev not in scans:
            scans[dev] = rowcompact_scan(codes.to(dev), gene_index.k, gene_index.w)
        a, c = match_rows_batch(
            *scans[dev], *table[:7], cap_cand=CANDIDATE_CAP, cap_anchors=ANCHOR_CAP,
            lookup_iters=table.iters, max_occ=min(params.max_occ, DEVICE_MAX_OCC),
        )
        anchors.append(a.to(home))
        counts.append(c.to(home))
    del scans
    if len(shards) > 1:
        anchors, counts = [torch.cat(anchors, 2)], [torch.stack(counts).amax(0)]
    return chain_batch(
        anchors[0], counts[0], starts, gene_index.device_gene_lengths(home),
        k=gene_index.k, cap_chains=CHAIN_CAP, max_diag_drift=params.max_diag_drift,
        max_anchor_gap=params.max_anchor_gap, min_anchors=params.min_anchors,
    )


# One-genome seeding graphs a gene index keeps, the least recently used dropped first.  Each holds
# a private memory pool of about one genome's seeding (under genome_footprint of its length), so
# the graphs of one gene index hold at most _SEED_GRAPHS of those.
_SEED_GRAPHS = 8


def _seed_one_graphed(codes: torch.Tensor, starts: torch.Tensor, shards: list, gene_index: GeneIndex,
                      params: MapperParams) -> tuple[torch.Tensor, torch.Tensor]:
    r""":func:`seed_chunk` of one genome on a card, replayed from a CUDA graph.

    At batch 1 the scan, match and chain are ~430 small launches whose host
    time is several times the card's; so the chunk is captured once for each
    padded stream length and replayed: a copy of the stream and of the contig
    starts into the graph's inputs (the starts padded with ``2^31 - 1``, which
    no position reaches, to a power of two of at least 256), one launch.  The
    outputs are the graph's own buffers, valid until its next replay.
    """
    from kaptive_tpu_torch.ops.scan_cuda import rowcompact_counter

    width = max(256, 1 << (starts.shape[1] - 1).bit_length())
    key = (str(codes.device), tuple(codes.shape), width, params.max_occ, params.max_diag_drift,
           params.max_anchor_gap, params.min_anchors, CANDIDATE_CAP, ANCHOR_CAP, CHAIN_CAP)
    graphs = gene_index._cache.setdefault("seed_graphs", {})
    entry = graphs.pop(key, None)
    if entry is None:
        while len(graphs) >= _SEED_GRAPHS:
            graphs.pop(next(iter(graphs)))
        entry = [None, torch.empty_like(codes), codes.new_empty((1, width), dtype=torch.int64), None]
    graphs[key] = entry  # the most recently used last
    in_codes, in_starts = entry[1], entry[2]
    in_codes.copy_(codes)
    in_starts.fill_(_BIG)
    in_starts[:, : starts.shape[1]] = starts
    if entry[0] is None:
        entry[0], entry[3] = _capture_seed(in_codes, in_starts, shards, gene_index, params)
    entry[0].replay()
    count(rowcompact_counter(gene_index.k, gene_index.w))
    count("map.seed_graph")
    return entry[3]


def _capture_seed(codes, starts, shards: list, gene_index: GeneIndex, params: MapperParams):
    r"""``(graph, outputs)`` of :func:`seed_chunk` captured over the input buffers ``codes`` and
    ``starts`` on their card, after one run outside the capture (lazy loads, sort workspaces)."""
    dev = codes.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        seed_chunk(codes, starts, shards, gene_index, params)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = seed_chunk(codes, starts, shards, gene_index, params)
    count("map.seed_graph.capture")
    return graph, out


def _map_genes_device_seeded(
    gene_index: GeneIndex, genomes: list, indexes: list,
    gene_names: tuple[str, ...], params: MapperParams, device: torch.device,
    chunk: int | None = None,
) -> list[Alignments]:
    r"""Device-seeded mapping of a batch: unpack, scan, match and chain in
    chunks of ``chunk`` genomes (:func:`seeding_chunk` when not given), one
    copy back of counts and chain prefixes, host checks and extension specs,
    one extension-DP sweep over the whole batch's flattened stream, one copy
    back of its results.

    Device memory of the seeding stages is bounded by one chunk whatever the
    batch, as the JAX package's fixed chunks bound it (``SCAN_CHUNK``); the
    alignments do not depend on the chunk size.  On a card a batch of one
    genome replays a captured graph (:func:`_seed_one_graphed`).  A genome that
    overflowed a device buffer is seeded on the host (:func:`_device_chains`);
    either way its extension problems are gathered from the device stream.
    """
    n_genomes = len(genomes)
    L = max(int(ci.codes.shape[0]) for ci in indexes)
    chunk = chunk or seeding_chunk(L, n_genomes, device)
    shards = [(device, gene_index.seed_table(device))]
    bounds = [(lo, min(lo + chunk, n_genomes)) for lo in range(0, n_genomes, chunk)]
    padded, chunk_starts, chain_parts, count_parts = None, [], [], []
    with phase_timer("map.pack_upload"):
        for lo, hi in bounds:
            codes, starts = _batch_codes(indexes[lo:hi], L, device)
            chunk_starts.append(starts)
            if hi - lo == n_genomes:
                padded = codes
            else:
                if padded is None:
                    padded = codes.new_empty((n_genomes, *codes.shape[1:]))
                padded[lo:hi] = codes
                del codes
    # The card's seeding, from the resident streams to the chains on the host.
    with phase_timer("map.seed_device") as seed_span:
        with phase_timer("map.scan_match"):
            # A graph's outputs are overwritten by its next replay, so only a batch of one replays one.
            seed = _seed_one_graphed if device.type == "cuda" and n_genomes == 1 else seed_chunk
            for (lo, hi), starts in zip(bounds, chunk_starts):
                chains_d, counts_d = seed(padded[lo:hi], starts, shards, gene_index, params)
                chain_parts.append(chains_d)
                count_parts.append(counts_d)
            chains_d, counts_d = torch.cat(chain_parts), torch.cat(count_parts, 1)
        with phase_timer("map.scan_sync"):
            pulled = torch.cat([counts_d.reshape(-1), chains_d[:, :, :CHAIN_PREFIX].reshape(-1)]).cpu().numpy()
            counts_np = pulled[: counts_d.numel()].reshape(6, n_genomes).astype(np.int64)
            chains_np = pulled[counts_d.numel():].reshape(n_genomes, len(_CHAIN_FIELDS), -1)
            if int(counts_np[5].max(initial=0)) > chains_np.shape[-1]:
                count("map.chain_prefix_miss")
                chains_np = chains_d.cpu().numpy()
    if seed_span:
        n_host = int(np.any(list(_overflows(counts_np).values()), axis=0).sum())
        seed_span.add("map.device_seeded", n_genomes - n_host)
        if n_host:
            seed_span.add("map.host_fallback", n_host)

    with phase_timer("map.problems"):
        all_chains = []
        for b, ci in enumerate(indexes):
            chains = _device_chains(counts_np, chains_np, b, ci, gene_index, params)
            all_chains.append(chains if chains and len(chains["gene"]) else None)
    return _extend_on_device(
        all_chains, gene_index, genomes, indexes, gene_names, params, padded.reshape(-1), L + 2 * PAD_POS
    )


def _map_genes_sharded(
    gene_index: GeneIndex, genomes: list, indexes: list,
    gene_names: tuple[str, ...], params: MapperParams, mesh, device: torch.device,
) -> list[Alignments]:
    r"""Seeding and chaining on the mesh (:func:`~kaptive_tpu_torch.parallel.typing.sharded_scan_match_chain`),
    then the one-device tail (:func:`_extend_on_device`) with the DP sweep cut over the mesh.

    Each fallback cause is held against its per-shard cap, as in the JAX
    package's sharded tail.
    """
    from kaptive_tpu_torch.parallel.typing import ShardedGeneTable, sharded_scan_match_chain

    L = max(int(ci.codes.shape[0]) for ci in indexes)
    table = ShardedGeneTable.of(gene_index, mesh.shape["model"])
    with phase_timer("map.scan_match"):
        chains_np, counts_np = sharded_scan_match_chain(mesh, indexes, table, gene_index, params, length=L)
    with phase_timer("map.problems"):
        all_chains = []
        for b, ci in enumerate(indexes):
            chains = _device_chains(counts_np, chains_np, b, ci, gene_index, params)
            all_chains.append(chains if chains and len(chains["gene"]) else None)
    with phase_timer("map.pack_upload"):
        padded, _ = _batch_codes(indexes, L, device)
    return _extend_on_device(
        all_chains, gene_index, genomes, indexes, gene_names, params, padded.reshape(-1), L + 2 * PAD_POS, mesh
    )


def map_genes_batch(
    gene_index: GeneIndex,
    genomes: list,
    gene_names: tuple[str, ...],
    params: MapperParams | None = None,
    *,
    indexes: list[ContigIndex] | None = None,
    seed_mode: str | None = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> list[Alignments]:
    r"""Map the DB gene set against a batch of assemblies on ``device``.

    ``indexes`` are the assemblies' :class:`ContigIndex` objects (built here
    when not given; the streaming pipeline builds them on its ingest pool,
    pre-seeded in host mode and pre-uploaded in device mode).  ``seed_mode``
    is resolved by :func:`resolve_seed_mode` on ``device``; both modes give the
    same alignments.  A ``mesh`` of more than one slot
    (:func:`~kaptive_tpu_torch.parallel.mesh.make_mesh`) seeds on the mesh
    whatever the seed mode, as the JAX package does: assemblies over its
    ``data`` axis, the gene table over its ``model`` axis, the DP pairs over
    every slot; the alignments are the same.
    """
    params = params or MapperParams()
    n_genomes = len(genomes)
    if n_genomes == 0:
        return []
    if indexes is None:
        indexes = [ContigIndex.build(g.contigs) for g in genomes]
    if len(gene_index.minimizers.hashes) == 0:  # empty DB gene table
        return [Alignments.empty() for _ in range(n_genomes)]
    device = resolve_device(device)
    mode = resolve_seed_mode(seed_mode, device)
    if sharded(mesh):
        return _map_genes_sharded(gene_index, genomes, indexes, gene_names, params, mesh, device)
    if mode == "device":
        return _map_genes_device_seeded(gene_index, genomes, indexes, gene_names, params, device)
    return _map_genes_host_seeded(gene_index, genomes, indexes, gene_names, params, device)


def map_genes(
    gene_index: GeneIndex,
    genome: GenomeAssembly,
    gene_names: tuple[str, ...],
    params: MapperParams | None = None,
    *,
    seed_mode: str | None = None,
    device: str | torch.device = "cuda",
    mesh=None,
) -> Alignments:
    r"""Map every DB gene against one assembly's contigs: :func:`map_genes_batch` on
    a batch of one (the JAX package's ``map_genes``).

    q_names are the DB gene indices as strings and t_names the contig names.
    """
    return map_genes_batch(gene_index, [genome], gene_names, params, seed_mode=seed_mode, device=device, mesh=mesh)[0]
