r"""Locus screening on PyTorch: the scoring phase of typing over a batch of assemblies.

Counterpart of :mod:`kaptive_tpu.parallel.screen` (one device; the sharded
screen is multi-GPU work).  Per assembly: a minimizer scan of its code
stream, a capped lookup of every selected minimizer in the DB gene table
(``MAX_OCC`` entries at most, the JAX package's cap), float32 tallies per
gene, then per-locus scores by a one-hot float32 matmul with the reference's
``completeness**3`` weighting, and the best locus by ``argmax`` (the first
index wins ties, as in ``jnp.argmax``).

The scan is the row-compact front door (:func:`kaptive_tpu_torch.ops.scan.rowcompact_scan`):
the Hopper kernel for a batch on the card, the plain version on the CPU.  Its
selection equals the flat ``minimizer_scan`` the JAX screen runs when both
see the same stream length, so the batch keeps the JAX package's stream
width.  A genome with a row of more than 64 minimizers (the kernel's row
capacity) is tallied from the flat plain scan instead, on the same device,
and counted as ``screen.overflow``: a semantic path, taken whatever the
kernel did, and not a fallback from a failed one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kaptive_tpu.utils.metrics import count

from kaptive_tpu_torch.ops.minimizer import DEFAULT_K, DEFAULT_W, bucket_length, concat_with_sentinels, encode_dna
from kaptive_tpu_torch.ops.scan import (
    SLOTS,
    add_halo,
    as_uint32_values,
    minimizer_scan_plain,
    rowcompact_scan,
)

MAX_OCC = 8  # per-minimizer occurrence cap of the table lookup


@dataclass(frozen=True)
class ScreenTables:
    r"""The DB arrays the screen scores against (host numpy, uploaded per device on demand)."""

    table_hashes: np.ndarray  # (T,) uint32 sorted gene-minimizer hashes
    table_genes: np.ndarray  # (T,) int32 gene index per table entry
    gene_locus_onehot: np.ndarray  # (G, NL) f32, expected genes only
    expected_per_locus: np.ndarray  # (NL,) f32
    gene_minimizer_counts: np.ndarray  # (G,) f32 minimizers per gene (for coverage proxy)
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, db, gene_index) -> ScreenTables:
        r"""The tables of ``db`` from the port's :class:`~kaptive_tpu_torch.ops.mapper.GeneIndex`
        (``ScreenTables.from_database``'s arrays, without ``db.gene_index``, which imports jax)."""
        ms = gene_index.minimizers
        n_genes = len(db.genes)
        n_loci = len(db.loci)
        onehot = np.zeros((n_genes, n_loci), dtype=np.float32)
        expected = ~db.extra_genes
        onehot[np.arange(n_genes)[expected], db.gene_locus_indices[expected]] = 1.0
        counts = np.bincount(ms.seq_indices, minlength=n_genes).astype(np.float32)
        expected_per_locus = np.maximum(
            np.bincount(db.gene_locus_indices[expected], minlength=n_loci), 1
        ).astype(np.float32)
        return cls(
            ms.hashes.astype(np.uint32),
            ms.seq_indices.astype(np.int32),
            onehot,
            expected_per_locus,
            np.maximum(counts, 1.0),
        )

    def on(self, device: torch.device) -> dict[str, torch.Tensor]:
        r"""The tables on ``device`` (cached): hashes as int64 in ``[0, 2^32)``."""
        key = str(device)
        if key not in self._cache:
            self._cache[key] = {
                "hashes": torch.from_numpy(self.table_hashes.astype(np.int64)).to(device),
                "genes": torch.from_numpy(self.table_genes.astype(np.int64)).to(device),
                "onehot": torch.from_numpy(self.gene_locus_onehot).to(device),
                "expected": torch.from_numpy(self.expected_per_locus).to(device),
                "counts": torch.from_numpy(self.gene_minimizer_counts).to(device),
            }
        return self._cache[key]


def encode_assemblies_to_batch(assemblies) -> np.ndarray:
    r"""Each assembly's sentinel-separated code stream as one row of a (B, W) uint8 batch.

    ``W`` is ``bucket_length`` of the widest stream, the JAX package's screen
    width: the scan's end guards depend on the stream length, so the port
    scans at the same width to select the same minimizers.
    """
    rows = []
    for ga in assemblies:
        codes = encode_dna(ga.contigs.seqs)
        flat, _ = concat_with_sentinels(codes, ga.contigs.offsets, ga.contigs.lengths, DEFAULT_K)
        rows.append(flat)
    out = np.full((len(rows), bucket_length(max((len(r) for r in rows), default=1))), 4, dtype=np.uint8)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _tally(hashes: torch.Tensor, genome: torch.Tensor, tables: dict, n_genomes: int, n_genes: int):
    r"""(n_genomes, n_genes) float32 tallies of selected minimizer ``hashes`` (int64) owned by ``genome``."""
    th, tg = tables["hashes"], tables["genes"]
    t_len = th.shape[0]
    lo = torch.searchsorted(th, hashes)
    tally = torch.zeros(n_genomes * (n_genes + 1), dtype=torch.float32, device=hashes.device)
    base = genome * (n_genes + 1)
    for o in range(MAX_OCC):
        in_bounds = lo + o < t_len  # clamping alone would re-count the last entry
        idx = (lo + o).clamp(max=t_len - 1)
        g = torch.where(in_bounds & (th[idx] == hashes), tg[idx], n_genes)
        tally.index_add_(0, base + g, torch.ones_like(hashes, dtype=torch.float32))
    return tally.reshape(n_genomes, n_genes + 1)[:, :n_genes]


def score_from_tallies(tallies: torch.Tensor, tables: dict):
    r"""``(best, weighted)`` from (B, G) float32 tallies (``_score_from_tallies``)."""
    covs = (tallies / tables["counts"][None, :]).clamp(0.0, 1.0)
    locus_scores = covs @ tables["onehot"]
    hit = (tallies > 0).to(torch.float32)
    completeness = (hit @ tables["onehot"]) / tables["expected"][None, :]
    weighted = locus_scores * (completeness * completeness * completeness)
    return weighted.argmax(dim=1).to(torch.int32), weighted


def locus_screen_batch(codes: torch.Tensor, tables: ScreenTables, n_genes: int):
    r"""Best locus and weighted locus scores of a (B, L) uint8 code batch on its device.

    ``L`` must be a multiple of 128 (:func:`~kaptive_tpu_torch.ops.minimizer.bucket_length`
    widths are).  Returns ``(best (B,) int32, weighted (B, NL) float32,
    tallies (B, G) float32)``, all on the device of ``codes``.
    """
    dev = codes.device
    B, L = codes.shape
    tab = tables.on(dev)
    h_rows, aux_rows, counts = rowcompact_scan(add_halo(codes), DEFAULT_K, DEFAULT_W)
    live = aux_rows >= 0
    genome = torch.arange(B, device=dev)[:, None, None].expand_as(live)
    tallies = _tally(as_uint32_values(h_rows[live]), genome[live], tab, B, n_genes)
    overflow = (counts.reshape(B, -1) > SLOTS).any(-1)
    if bool(overflow.any()):
        over = overflow.nonzero()[:, 0]
        count("screen.overflow", int(over.numel()))
        sel, hashes, _ = minimizer_scan_plain(codes[over], DEFAULT_K, DEFAULT_W)
        owner = torch.arange(over.numel(), device=dev)[:, None].expand_as(sel)
        tallies[over] = _tally(hashes[sel], owner[sel], tab, int(over.numel()), n_genes)
    best, weighted = score_from_tallies(tallies, tab)
    return best, weighted, tallies
