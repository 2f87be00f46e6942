r"""Streaming batch typing: host ingest overlapped with device compute.

Counterpart of :mod:`kaptive_tpu.parallel.pipeline`.  A thread pool parses
each assembly and builds its :class:`ContigIndex` while the card works on the
batch before; then, by :func:`resolve_seed_mode`:

- host seeding: the pool seeds and chains the assembly against the DB gene
  table (the native C scan releases the GIL);
- device seeding: the pool builds the assembly's upload form and copies it to
  the card, returning once the copy has landed (``ingest.h2d_wait``);
- on a mesh of more than one slot (``multi_device``) the pool only parses
  and indexes: the mapper seeds on the mesh and uploads each data row's
  slice itself.

``prefetch_batches`` is how many batches the pool ingests ahead of the one
the consumer holds; both functions take the JAX package's parameters in its
positions, with its defaults.

``map_batch`` runs on one worker thread and overlaps ``finish_batch`` of the
batch before it on the calling thread; results stream in input order.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Iterable, Iterator
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import IO

import torch

from kaptive_tpu_torch.core.genome import GenomeAssembly
from kaptive_tpu_torch.ops.mapper import device_inputs, host_seed_chains, resolve_seed_mode, upload_form
from kaptive_tpu_torch.ops.minimizer import ContigIndex
from kaptive_tpu_torch.utils.device import sharded
from kaptive_tpu_torch.utils.profiling import phase_timer

Ingested = tuple[GenomeAssembly, ContigIndex]
PreSeed = Callable[[ContigIndex], tuple]
PREFETCH_BATCHES = 2  # stream_type's default depth: batches ingested ahead of the one the consumer holds


def _load_and_index(path: str | Path | IO[bytes], pre_seed: PreSeed | None, upload_to: torch.device | None) -> Ingested:
    with phase_timer("ingest.parse_pack"):
        ga = GenomeAssembly.ensure(path)
        ci = ContigIndex.build(ga.contigs)
        if pre_seed is not None:
            # Seed and chain here on the pool; the mapping phase finds the
            # chains ready.  The entry is keyed by (gene_index, params).
            ci._cache["host_chains"] = pre_seed(ci)
        elif upload_to is not None:
            upload_form(ci)  # the host half of the upload
    if upload_to is not None:
        with phase_timer("ingest.h2d_wait"):
            device_inputs(ci, upload_to)
    return ga, ci


def stream_batches(
    genomes: Iterable[str | Path | IO[bytes]],
    batch_size: int = 8,
    prefetch_batches: int = 1,
    max_workers: int | None = None,
    multi_device: bool = False,
    pre_seed: PreSeed | None = None,
    *,
    upload_to: torch.device | None = None,
) -> Iterator[list[Ingested]]:
    r"""Yield ingested ``(assembly, contig index)`` batches, ``prefetch_batches``
    batches ahead of the consumer.  ``max_workers`` sizes the ingest pool
    (``None``: the machine's core count, between 2 and 16).  ``pre_seed(ci)``
    returns the ``host_chains`` entry (host seeding); ``upload_to`` is the
    device each assembly's upload form is copied to (device seeding), unless
    ``multi_device`` says that a mesh's mapper uploads the batch itself."""
    if prefetch_batches < 0:
        raise ValueError(f"prefetch_batches must be >= 0, got {prefetch_batches}")
    if multi_device:
        upload_to = None
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
    if max_workers is None:
        max_workers = max(2, min(16, os.cpu_count() or 8))
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        pending = [
            [pool.submit(_load_and_index, g, pre_seed, upload_to) for g in groups[gi]]
            for gi in range(min(prefetch_batches + 1, len(groups)))
        ]
        next_submit = len(pending)
        for _ in range(len(groups)):
            futures = pending.pop(0)
            if next_submit < len(groups):
                pending.append([pool.submit(_load_and_index, g, pre_seed, upload_to) for g in groups[next_submit]])
                next_submit += 1
            yield [f.result() for f in futures]


def auto_batch_size(per_device: int = 16) -> int:
    r"""Default assemblies per stream batch of the command line, which types on one card."""
    return per_device


def stream_type(
    serotyper,
    genomes: Iterable[str | Path | IO[bytes]],
    batch_size: int = 8,
    prefetch_batches: int = PREFETCH_BATCHES,
    max_workers: int | None = None,
):
    r"""Generator of SerotypingResult over a streamed, prefetched genome list.

    Two-stage pipeline: batch k+1's ``Serotyper.map_batch`` (one worker
    thread) overlaps batch k's ``Serotyper.finish_batch`` (this thread).  The
    ingest pool pre-seeds every assembly against the serotyper's gene index
    in host mode, and pre-uploads it to the serotyper's device in device mode;
    with a mesh of more than one slot it does neither.  ``map_batch`` stays on
    one thread on a mesh too: its launches on several cards are asynchronous.
    ``prefetch_batches`` and ``max_workers`` are :func:`stream_batches`'s.
    """
    if sharded(getattr(serotyper, "mesh", None)):
        batches = stream_batches(genomes, batch_size, prefetch_batches, max_workers, multi_device=True)
    elif resolve_seed_mode() == "host":
        gene_index = serotyper.gene_index
        mp = serotyper.mapper_params
        gene_index.host_bloom  # build once before the pool fans out
        gene_index.host_buckets

        def pre_seed(ci: ContigIndex) -> tuple:
            return gene_index, mp, host_seed_chains(gene_index, ci, mp)

        batches = stream_batches(genomes, batch_size, prefetch_batches, max_workers, pre_seed=pre_seed)
    else:
        batches = stream_batches(genomes, batch_size, prefetch_batches, max_workers, upload_to=serotyper.device)
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
