r"""Sharded typing on a device mesh (counterpart of :mod:`kaptive_tpu.parallel.typing`).

The mapper's device stages and the banded-SWG sweeps run over the slots of a
:class:`~kaptive_tpu_torch.parallel.mesh.Mesh`:

- **data axis** — assemblies: each data row seeds its slice of the batch
  (the row-compact scan, :func:`~kaptive_tpu_torch.ops.scan.rowcompact_scan`,
  the Hopper kernel on a card).
- **model axis** — the DB gene-minimizer table, cut by hash range into
  contiguous slices of the sorted table, each with its own bucket index and
  bloom bitmap (:class:`ShardedGeneTable`).  Each model slot matches the
  row's scan against its shard only; the shards' anchor sets are disjoint,
  so the merge (the JAX package's ``all_gather`` over ``model``) copies each
  shard's anchors to the row's first device and concatenates them.  Chaining
  sorts on composite keys and masks on ``valid``, so the merged chains equal
  the single-device chains.
- The extension and protein DP pair axis is cut over every slot in flattened
  ``(data, model)`` order (:func:`~kaptive_tpu_torch.ops.swg.sharded_banded_swg`,
  beside ``banded_swg``; its JAX name is kept here): pairs are independent.

A chunk's seeding is :func:`~kaptive_tpu_torch.ops.mapper.seed_chunk`, the
single-device path's own, given a row's table shards in place of the whole
table; the shards take the whole table's layout
(:class:`~kaptive_tpu_torch.ops.mapper.SeedTable`).

Launches on distinct cards are asynchronous, so their shards overlap; shards
on one card run one after another.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kaptive_tpu_torch.ops.mapper import (
    GeneIndex,
    MapperParams,
    SeedTable,
    _batch_codes,
    lookup_iters,
    seed_chunk,
    seeding_chunk,
    table_bloom,
    table_buckets,
    table_run_lengths,
)
from kaptive_tpu_torch.ops.minimizer import ContigIndex
from kaptive_tpu_torch.ops.swg import sharded_banded_swg
from kaptive_tpu_torch.parallel.mesh import Mesh
from kaptive_tpu_torch.utils.device import device_count

__all__ = [
    "ShardedGeneTable",
    "device_count",
    "shard_cuts",
    "sharded_banded_swg",
    "sharded_scan_match_chain",
]


def shard_cuts(sorted_hashes: np.ndarray, model: int) -> list[int]:
    r"""Even hash-range cut points for ``model`` table shards, aligned to hash-run boundaries.

    A run straddling a cut would be capped on both sides and merge to more
    than the single-device occurrence cap, so interior cuts advance to the
    next run start.
    """
    n = len(sorted_hashes)
    cuts = [round(i * n / model) for i in range(model + 1)]
    for i in range(1, model):
        c = cuts[i]
        while 0 < c < n and sorted_hashes[c] == sorted_hashes[c - 1]:
            c += 1
        cuts[i] = max(min(c, n), cuts[i - 1])
    return cuts


@dataclass(frozen=True)
class ShardedGeneTable:
    r"""Hash-range shards of the gene minimizer table, stacked shard after shard.

    Every shard is padded to a common length ``T_shard``; pad entries carry
    the hash ``0xFFFFFFFF`` and run length 0, and each shard's bloom bitmap
    covers only its own entries.  The arrays equal the JAX package's;
    :meth:`shard` gives one shard in the port's device-table layout.
    """

    hashes: np.ndarray  # (model * T_shard,) uint32
    genes: np.ndarray  # (model * T_shard,) int32
    positions: np.ndarray  # (model * T_shard,) int32
    strands: np.ndarray  # (model * T_shard,) bool
    bucket_starts: np.ndarray  # (model * (n_buckets + 1),) int32
    run_len: np.ndarray  # (model * T_shard,) int32
    bloom: np.ndarray  # (model * n_words,) uint32
    lookup_iters: int
    model: int

    @classmethod
    def build(cls, gene_index: GeneIndex, model: int) -> ShardedGeneTable:
        ms = gene_index.minimizers
        h = ms.hashes  # sorted
        cuts = shard_cuts(h, model)
        t_shard = max(max(cuts[i + 1] - cuts[i] for i in range(model)), 1)

        hashes = np.full((model, t_shard), np.uint32(0xFFFFFFFF), dtype=np.uint32)
        genes = np.zeros((model, t_shard), dtype=np.int32)
        positions = np.zeros((model, t_shard), dtype=np.int32)
        strands = np.zeros((model, t_shard), dtype=bool)
        bucket_starts, run_len, bloom = [], [], []
        for s in range(model):
            lo, hi = cuts[s], cuts[s + 1]
            span = hi - lo
            hashes[s, :span] = h[lo:hi]
            genes[s, :span] = ms.seq_indices[lo:hi]
            positions[s, :span] = ms.positions[lo:hi]
            strands[s, :span] = ms.strands[lo:hi]
            bucket_starts.append(table_buckets(hashes[s]))
            runs = table_run_lengths(hashes[s]).astype(np.int32)
            runs[span:] = 0  # pad entries share the max hash
            run_len.append(runs)
            bloom.append(table_bloom(h[lo:hi]))
        return cls(
            hashes.reshape(-1), genes.reshape(-1), positions.reshape(-1), strands.reshape(-1),
            np.concatenate(bucket_starts), np.concatenate(run_len), np.concatenate(bloom),
            max(lookup_iters(b) for b in bucket_starts), model,
        )

    @classmethod
    def of(cls, gene_index: GeneIndex, model: int) -> ShardedGeneTable:
        r"""The table of ``gene_index`` cut into ``model`` shards (cached on the index)."""
        key = ("sharded_table", model)
        if key not in gene_index._cache:
            gene_index._cache[key] = cls.build(gene_index, model)
        return gene_index._cache[key]

    def shard(self, gene_index: GeneIndex, s: int, device: torch.device) -> SeedTable:
        r"""Shard ``s`` on ``device`` in the whole table's layout, searched in
        :attr:`lookup_iters` steps (the maximum over shards).

        Cached on ``gene_index`` under the model size, the shard index and the
        device, so slots that repeat a device share one copy.
        """

        def make(dev):
            t = self.hashes.shape[0] // self.model
            nb = self.bucket_starts.shape[0] // self.model
            nw = self.bloom.shape[0] // self.model
            rows, buckets, words = slice(s * t, (s + 1) * t), slice(s * nb, (s + 1) * nb), slice(s * nw, (s + 1) * nw)
            return SeedTable.upload(
                dev, self.hashes[rows], self.genes[rows], self.positions[rows], self.strands[rows],
                self.bucket_starts[buckets], self.run_len[rows], self.bloom[words], self.lookup_iters,
            )

        return gene_index._on_device(("sharded_table", self.model, s), device, make)


def _row_slices(mesh: Mesh, n: int) -> list[slice]:
    r"""Each data row's slice of a batch of ``n``, padded to the data axis: a row
    past the batch's end is padding (empty streams, which seed nothing)."""
    data = mesh.shape["data"]
    per = -(-n // data)
    return [slice(min(d * per, n), min((d + 1) * per, n)) for d in range(data)]


def sharded_scan_match_chain(
    mesh: Mesh,
    indexes: list[ContigIndex],
    table: ShardedGeneTable,
    gene_index: GeneIndex,
    params: MapperParams,
    *,
    length: int,
) -> tuple[np.ndarray, np.ndarray]:
    r"""Seeding and chaining of a batch on the mesh.

    Data row ``d`` takes its slice of ``indexes`` (:func:`_row_slices`) in
    chunks sized by :func:`~kaptive_tpu_torch.ops.mapper.seeding_chunk` on
    the row's devices, each card's free memory shared by its slots, a genome's
    anchors counted once for each table shard (they are chained together).  A chunk
    is unpacked on the row's first device and goes through
    :func:`~kaptive_tpu_torch.ops.mapper.seed_chunk` with the row's table
    shards, model slot ``s`` holding shard ``s``.  The caps are the
    single-device path's, held per shard.

    Returns ``(chains (B, 10, CHAIN_CAP) int32, counts (6, B) int32)`` on the
    host, in :func:`~kaptive_tpu_torch.ops.mapper.chain_batch`'s layout.
    """
    chain_parts, count_parts = [], []
    for d, rows in enumerate(_row_slices(mesh, len(indexes))):
        row = indexes[rows]
        if not row:
            continue
        devs = list(mesh.devices[d])
        shards = [(dev, table.shard(gene_index, s, dev)) for s, dev in enumerate(devs)]
        size = min(seeding_chunk(length, len(row), dev, mesh.slots_on(dev), len(shards)) for dev in set(devs))
        for lo in range(0, len(row), size):
            codes, starts = _batch_codes(row[lo : lo + size], length, devs[0])
            chains, counts = seed_chunk(codes, starts, shards, gene_index, params)
            del codes
            chain_parts.append(chains)
            count_parts.append(counts)
    # One copy back a part after every row's launches, so rows on distinct cards overlap.
    return (torch.cat([c.cpu() for c in chain_parts]).numpy(),
            torch.cat([c.cpu() for c in count_parts], 1).numpy())
