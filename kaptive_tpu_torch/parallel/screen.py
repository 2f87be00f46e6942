r"""Locus screening on PyTorch: the scoring phase of typing over a batch of assemblies.

Counterpart of :mod:`kaptive_tpu.parallel.screen`.  Per assembly: a minimizer
scan of its code stream, a capped lookup of every selected minimizer in the
DB gene table (``MAX_OCC`` entries at most, the JAX package's cap), float32
tallies per gene, then per-locus scores by a one-hot float32 matmul with the
reference's ``completeness**3`` weighting, and the best locus by ``argmax``
(the first index wins ties, as in ``jnp.argmax``).

The scan is the row-compact front door (:func:`kaptive_tpu_torch.ops.scan.rowcompact_scan`):
the Hopper kernel for a batch on the card, the plain version on the CPU.  Its
selection equals the flat ``minimizer_scan`` the JAX screen runs when both
see the same stream length, so the batch keeps the JAX package's stream
width.  A genome with a row of more than 64 minimizers (the kernel's row
capacity) is tallied from the flat scan instead
(:func:`~kaptive_tpu_torch.ops.minimizer.minimizer_scan`: the flat-scan
kernel on a card, the plain version on the CPU), on the same device, and
counted as ``screen.overflow``: a semantic path, taken whatever the kernel
did, and not a fallback from a failed one.

:func:`sharded_locus_screen` runs the same steps on a device mesh:
assemblies over its ``data`` axis, the gene table cut by hash runs over its
``model`` axis, the shards' tallies summed (the JAX package's ``psum``) before
one scoring of the batch.  Tallies are integer counts in float32, so the sum
equals the single-device tallies exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kaptive_tpu_torch.ops.minimizer import (
    DEFAULT_K,
    DEFAULT_W,
    bucket_length,
    concat_with_sentinels,
    encode_dna,
    minimizer_scan,
)
from kaptive_tpu_torch.ops.scan import SLOTS, add_halo, as_uint32_values, rowcompact_scan
from kaptive_tpu_torch.parallel.typing import _row_slices, shard_cuts
from kaptive_tpu_torch.utils.metrics import count

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
    def from_database(cls, db) -> ScreenTables:
        r"""The tables of ``db`` (a :class:`~kaptive_tpu_torch.db.Database`), from its gene index."""
        return cls.build(db, db.gene_index)

    @classmethod
    def build(cls, db, gene_index) -> ScreenTables:
        r"""The tables of ``db`` from a :class:`~kaptive_tpu_torch.ops.mapper.GeneIndex` of its genes."""
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

    def shard(self, s: int, model: int, device: torch.device) -> dict[str, torch.Tensor]:
        r"""Shard ``s`` of ``model`` hash-run-aligned table shards
        (:func:`~kaptive_tpu_torch.parallel.typing.shard_cuts`) on ``device`` (cached)."""
        key = (model, s, str(device))
        if key not in self._cache:
            cuts = shard_cuts(self.table_hashes, model)
            rows = slice(cuts[s], cuts[s + 1])
            self._cache[key] = {
                "hashes": torch.from_numpy(self.table_hashes[rows].astype(np.int64)).to(device),
                "genes": torch.from_numpy(self.table_genes[rows].astype(np.int64)).to(device),
            }
        return self._cache[key]


def encode_assemblies_to_batch(assemblies, pad_to: int | None = None) -> np.ndarray:
    r"""Each assembly's sentinel-separated code stream as one row of a (B, W) uint8 batch.

    ``W`` is ``pad_to`` (a longer stream is cut to it), else ``bucket_length``
    of the widest stream, the JAX package's screen width: the scan's end
    guards depend on the stream length, so the port scans at the same width
    to select the same minimizers.  :func:`locus_screen_batch` takes widths
    that are multiples of 128.
    """
    rows = []
    for ga in assemblies:
        codes = encode_dna(ga.contigs.seqs)
        flat, _ = concat_with_sentinels(codes, ga.contigs.offsets, ga.contigs.lengths, DEFAULT_K)
        rows.append(flat)
    width = pad_to or bucket_length(max((len(r) for r in rows), default=1))
    out = np.full((len(rows), width), 4, dtype=np.uint8)
    for i, r in enumerate(rows):
        out[i, : min(len(r), width)] = r[:width]
    return out


def _tally(hashes: torch.Tensor, genome: torch.Tensor, tables: dict, n_genomes: int, n_genes: int):
    r"""(n_genomes, n_genes) float32 tallies of selected minimizer ``hashes`` (int64) owned by ``genome``."""
    th, tg = tables["hashes"], tables["genes"]
    t_len = th.shape[0]
    tally = torch.zeros(n_genomes * (n_genes + 1), dtype=torch.float32, device=hashes.device)
    if t_len == 0:  # an empty table shard
        return tally.reshape(n_genomes, n_genes + 1)[:, :n_genes]
    lo = torch.searchsorted(th, hashes)
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


def _shard_tallies(codes: torch.Tensor, shards: list, n_genes: int) -> torch.Tensor:
    r"""(B, G) float32 tallies of a (B, L) code batch against each table shard
    ``(device, tables)``, summed on the device of ``codes``.

    The batch is scanned once on each distinct device of ``shards``; genomes
    with an overflowing scan row are tallied from the flat scan.
    """
    home = codes.device
    B = codes.shape[0]
    scans: dict[torch.device, tuple] = {}
    total = None
    for dev, tab in shards:
        if dev not in scans:
            c = codes.to(dev)
            h_rows, aux_rows, counts = rowcompact_scan(add_halo(c), DEFAULT_K, DEFAULT_W)
            live = aux_rows >= 0
            genome = torch.arange(B, device=dev)[:, None, None].expand_as(live)
            over = (counts.reshape(B, -1) > SLOTS).any(-1).nonzero()[:, 0]
            flat = None
            if over.numel():
                if not scans:
                    count("screen.overflow", int(over.numel()))
                sel, hashes, _ = minimizer_scan(c[over], DEFAULT_K, DEFAULT_W)
                owner = torch.arange(over.numel(), device=dev)[:, None].expand_as(sel)
                flat = (hashes[sel], owner[sel])
            scans[dev] = (as_uint32_values(h_rows[live]), genome[live], over, flat)
        hashes, owner, over, flat = scans[dev]
        tallies = _tally(hashes, owner, tab, B, n_genes)
        if flat is not None:
            tallies[over] = _tally(*flat, tab, int(over.numel()), n_genes)
        total = tallies.to(home) if total is None else total + tallies.to(home)
    return total


def locus_screen_batch(codes: torch.Tensor, tables: ScreenTables, n_genes: int):
    r"""Best locus and weighted locus scores of a (B, L) uint8 code batch on its device.

    ``L`` must be a multiple of 128 (:func:`~kaptive_tpu_torch.ops.minimizer.bucket_length`
    widths are).  Returns ``(best (B,) int32, weighted (B, NL) float32,
    tallies (B, G) float32)``, all on the device of ``codes``.
    """
    tab = tables.on(codes.device)
    tallies = _shard_tallies(codes, [(codes.device, tab)], n_genes)
    best, weighted = score_from_tallies(tallies, tab)
    return best, weighted, tallies


def sharded_locus_screen(mesh, codes_batch: np.ndarray, tables: ScreenTables):
    r"""The screen on a mesh: assemblies over ``data``, gene table over ``model``.

    Data row ``d`` takes its slice of the (B, L) uint8 batch (padded to the
    data axis: a row past the batch's end screens nothing), scans it on each
    distinct device of the row and tallies it against each model slot's
    hash-run-aligned table shard; the shards' tallies are summed (the
    ``psum``), and the whole batch is scored once on the mesh's first device.
    Returns :func:`locus_screen_batch`'s ``(best, weighted, tallies)`` on that
    device, equal to the single-device screen's.
    """
    n_genes = tables.gene_locus_onehot.shape[0]
    model = mesh.shape["model"]
    home = mesh.flat[0]
    parts = []
    for d, rows in enumerate(_row_slices(mesh, codes_batch.shape[0])):
        if rows.start == rows.stop:
            continue
        devs = list(mesh.devices[d])
        codes = torch.from_numpy(np.ascontiguousarray(codes_batch[rows])).to(devs[0])
        shards = [(dev, tables.shard(s, model, dev)) for s, dev in enumerate(devs)]
        parts.append(_shard_tallies(codes, shards, n_genes))
    tallies = torch.cat([p.to(home) for p in parts])
    best, weighted = score_from_tallies(tallies, tables.on(home))
    return best, weighted, tallies
