r"""Streaming batch typing: host ingest and seeding overlapped with device compute.

Counterpart of :mod:`kaptive_tpu.parallel.pipeline` in host-seeded mode.  A
thread pool parses each assembly, builds its :class:`ContigIndex` and seeds
and chains it against the DB gene table (the native C scan releases the
GIL) while the card works on the batch before.  ``map_batch`` runs on one
worker thread and overlaps ``finish_batch`` of the batch before it on the
calling thread; results stream in input order.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import IO

from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.utils.profiling import phase_timer

from kaptive_tpu_torch.ops.mapper import host_seed_chains
from kaptive_tpu_torch.ops.minimizer import ContigIndex

Ingested = tuple[GenomeAssembly, ContigIndex]
PREFETCH_BATCHES = 2  # batches ingested ahead of the one the consumer holds


def _load_and_index(path: str | Path | IO[bytes], pre_seed: Callable[[ContigIndex], tuple]) -> Ingested:
    with phase_timer("ingest.parse_pack"):
        ga = GenomeAssembly.ensure(path)
        ci = ContigIndex.build(ga.contigs)
        # Seed and chain here on the pool; the mapping phase finds the chains
        # ready.  The entry is keyed by (gene_index, params).
        ci._cache["host_chains"] = pre_seed(ci)
    return ga, ci


def stream_batches(
    genomes: Iterable[str | Path | IO[bytes]],
    pre_seed: Callable[[ContigIndex], tuple],
    batch_size: int,
) -> Iterator[list[Ingested]]:
    r"""Yield ingested, pre-seeded ``(assembly, contig index)`` batches, prefetching
    ahead of the consumer.  ``pre_seed(ci)`` returns the ``host_chains`` entry."""
    genome_list = list(genomes)
    if not genome_list:
        return
    # Ramp-up: the first batch's ingest overlaps nothing, so start with a
    # quarter batch and let every later ingest hide behind device work.
    first = max(batch_size // 4, 1) if len(genome_list) > batch_size else batch_size
    bounds = [0, first] if first < len(genome_list) else [0, len(genome_list)]
    while bounds[-1] < len(genome_list):
        bounds.append(min(bounds[-1] + batch_size, len(genome_list)))
    groups = [genome_list[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    # Ingest is CPU work with no blocking waits: size the pool to the machine.
    with ThreadPoolExecutor(max_workers=max(2, min(16, os.cpu_count() or 8))) as pool:
        pending = [
            [pool.submit(_load_and_index, g, pre_seed) for g in groups[gi]]
            for gi in range(min(PREFETCH_BATCHES + 1, len(groups)))
        ]
        next_submit = len(pending)
        for _ in range(len(groups)):
            futures = pending.pop(0)
            if next_submit < len(groups):
                pending.append([pool.submit(_load_and_index, g, pre_seed) for g in groups[next_submit]])
                next_submit += 1
            yield [f.result() for f in futures]


def stream_type(
    serotyper,
    genomes: Iterable[str | Path | IO[bytes]],
    batch_size: int = 8,
):
    r"""Generator of SerotypingResult over a streamed, prefetched genome list.

    Two-stage pipeline: batch k+1's ``Serotyper.map_batch`` (one worker
    thread) overlaps batch k's ``Serotyper.finish_batch`` (this thread).  The
    ingest pool pre-seeds every assembly against the serotyper's gene index.
    """
    gene_index = serotyper.gene_index
    mp = serotyper.mapper_params
    gene_index.host_bloom  # build once before the pool fans out
    gene_index.host_buckets

    def pre_seed(ci: ContigIndex) -> tuple:
        return gene_index, mp, host_seed_chains(gene_index, ci, mp)

    batches = stream_batches(genomes, pre_seed, batch_size)
    with ThreadPoolExecutor(max_workers=1) as device_stage:
        pending = None  # future over map_batch for the batch ahead
        for batch in batches:
            assemblies = [ga for ga, _ in batch]
            indexes = [ci for _, ci in batch]
            future = device_stage.submit(serotyper.map_batch, assemblies, indexes)
            if pending is not None:
                yield from serotyper.finish_batch(*pending.result())
            pending = future
        if pending is not None:
            yield from serotyper.finish_batch(*pending.result())
