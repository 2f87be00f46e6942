r"""Streaming batch typing: host ingest overlapped with device compute.

Counterpart of :mod:`kaptive_tpu.parallel.pipeline`.  A thread pool parses
each assembly and builds its :class:`ContigIndex` while the card works on the
batch before; then, by :func:`resolve_seed_mode` on the serotyper's device:

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
batch before it on the calling thread; results stream in input order.  Each
batch is one request (:func:`~kaptive_tpu_torch.utils.profiling.request_context`):
its ingest on the pool, its ``map_batch`` and its ``finish_batch`` carry one
request id, and the two waits of the stream are spans of their own
(``stream.wait_ingest`` on the pool's futures, ``stream.wait_map`` on
``map_batch``'s).
"""

from __future__ import annotations

import contextvars
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
from kaptive_tpu_torch.utils.profiling import phase_timer, request_context

Ingested = tuple[GenomeAssembly, ContigIndex]
PreSeed = Callable[[ContigIndex], tuple]
PREFETCH_BATCHES = 2  # stream_type's default depth: batches ingested ahead of the one the consumer holds


def _load_and_index(
    path: str | Path | IO[bytes], pre_seed: PreSeed | None, upload_to: torch.device | None,
    ctx: contextvars.Context | None = None,
) -> Ingested:
    if ctx is not None:  # the batch's request context, one copy an assembly
        return ctx.run(_load_and_index, path, pre_seed, upload_to)
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
    for _, batch in _ingest(genomes, batch_size, prefetch_batches, max_workers, multi_device, pre_seed, upload_to):
        yield batch


def _wait_ingest(futures: list) -> list[Ingested]:
    with phase_timer("stream.wait_ingest"):
        return [f.result() for f in futures]


def _ingest(
    genomes: Iterable[str | Path | IO[bytes]], batch_size: int, prefetch_batches: int, max_workers: int | None,
    multi_device: bool, pre_seed: PreSeed | None, upload_to: torch.device | None,
) -> Iterator[tuple[contextvars.Context, list[Ingested]]]:
    r""":func:`stream_batches`, each batch with the context that carries its request id."""
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

        def submit(group: list) -> tuple[contextvars.Context, list]:
            ctx = request_context()
            return ctx, [pool.submit(_load_and_index, g, pre_seed, upload_to, ctx.copy()) for g in group]

        pending = [submit(groups[gi]) for gi in range(min(prefetch_batches + 1, len(groups)))]
        next_submit = len(pending)
        for _ in range(len(groups)):
            ctx, futures = pending.pop(0)
            if next_submit < len(groups):
                pending.append(submit(groups[next_submit]))
                next_submit += 1
            yield ctx, ctx.copy().run(_wait_ingest, futures)


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
        batches = _ingest(genomes, batch_size, prefetch_batches, max_workers, True, None, None)
    elif resolve_seed_mode(device=serotyper.device) == "host":
        gene_index = serotyper.gene_index
        mp = serotyper.mapper_params
        gene_index.host_bloom  # build once before the pool fans out
        gene_index.host_buckets

        def pre_seed(ci: ContigIndex) -> tuple:
            return gene_index, mp, host_seed_chains(gene_index, ci, mp)

        batches = _ingest(genomes, batch_size, prefetch_batches, max_workers, False, pre_seed, None)
    else:
        batches = _ingest(genomes, batch_size, prefetch_batches, max_workers, False, None, serotyper.device)
    with ThreadPoolExecutor(max_workers=1) as device_stage:
        pending = None  # (context, future over map_batch) for the batch ahead
        for ctx, batch in batches:
            assemblies = [ga for ga, _ in batch]
            indexes = [ci for _, ci in batch]
            future = device_stage.submit(ctx.copy().run, serotyper.map_batch, assemblies, indexes)
            if pending is not None:
                yield from pending[0].copy().run(_finish, serotyper, pending[1])
            pending = ctx, future
        if pending is not None:
            yield from pending[0].copy().run(_finish, serotyper, pending[1])


def _finish(serotyper, mapped) -> list:
    r"""``finish_batch`` over the batch that ``mapped`` (a future over ``map_batch``) gives."""
    with phase_timer("stream.wait_map"):
        assemblies, alns_list = mapped.result()
    return serotyper.finish_batch(assemblies, alns_list)
