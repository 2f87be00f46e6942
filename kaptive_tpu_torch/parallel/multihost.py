r"""Multi-host scaffolding: process init, input sharding, shard writers.

Counterpart of :mod:`kaptive_tpu.parallel.multihost`.  A run over many
machines (or many processes on one) needs three host-side pieces on top of
the device mesh of :mod:`kaptive_tpu_torch.parallel.mesh`, which one process
drives:

1. :func:`initialize_distributed` — an idempotent
   ``torch.distributed.init_process_group`` with the gloo backend, from
   explicit arguments or torchrun's environment (``MASTER_ADDR``,
   ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The scaffolding exchanges no
   tensors, so gloo serves on every machine, and two ranks may share one card
   (NCCL refuses that).
2. :func:`shard_inputs` — deterministic round-robin assignment of input files
   to processes, so every process streams a disjoint subset (no coordination
   beyond the rank).
3. :class:`ShardedJsonlWriter` — per-process JSONL shard files
   (``<stem>.part-NNNNN.jsonl``) with stream resume: on reopen it reads the
   shard and skips genomes already written, so a long run is idempotent per
   assembly.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import IO, Any

import torch.distributed as dist


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    r"""Join the process group once (gloo); returns True when distributed.

    ``coordinator_address`` is ``host:port`` (else ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (else ``WORLD_SIZE``)
    and ``process_id`` this process's rank (else ``RANK``).  With no
    coordinator the run stays single-process and this returns False, so the
    same entry path serves one process and many.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if not coordinator_address:
        return False
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes or int(os.environ.get("WORLD_SIZE", "1")),
        rank=process_id if process_id is not None else int(os.environ.get("RANK", "0")),
    )
    return True


def process_rank_and_count() -> tuple[int, int]:
    r"""(rank, world size) — (0, 1) when not distributed."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_inputs(inputs: list, rank: int | None = None, world: int | None = None) -> list:
    r"""Deterministic round-robin slice of the input list for this process.

    Round-robin (not contiguous blocks) keeps per-process work balanced when
    input files are sorted by size or name.
    """
    if rank is None or world is None:
        rank, world = process_rank_and_count()
    if world <= 1:
        return list(inputs)
    return [x for i, x in enumerate(inputs) if i % world == rank]


def shard_path(path: str | Path, rank: int | None = None, world: int | None = None) -> Path:
    r"""Per-process output shard path: ``x.jsonl`` -> ``x.part-00003.jsonl``.

    Single-process runs keep the plain path.
    """
    if rank is None or world is None:
        rank, world = process_rank_and_count()
    path = Path(path)
    if world <= 1:
        return path
    return path.with_name(f"{path.stem}.part-{rank:05d}{path.suffix}")


class ShardedJsonlWriter:
    r"""Append-mode JSONL shard writer with per-assembly stream resume.

    ``written`` holds the genome ids already present in the shard (loaded at
    open); :meth:`should_skip` lets the caller avoid re-typing them.
    """

    def __init__(self, path: str | Path, rank: int | None = None, world: int | None = None):
        self.path = shard_path(path, rank, world)
        self.written: set[str] = set()
        if self.path.exists():
            with self.path.open("rb") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self.written.add(json.loads(line)["genome"])
                    except (ValueError, KeyError):
                        continue  # torn tail line from an interrupted run
        self._handle: IO[bytes] = self.path.open("ab")
        # A crash can leave a torn final line; terminate it so appended
        # records stay line-delimited (the torn record is typed again).
        # Only the last byte is read.
        if self.path.stat().st_size:
            with self.path.open("rb") as fh:
                fh.seek(-1, 2)
                if fh.read(1) != b"\n":
                    self._handle.write(b"\n")

    def should_skip(self, genome_id: str) -> bool:
        return genome_id in self.written

    def write_result(self, result: Any) -> None:
        from kaptive_tpu_torch.serotyping.cli import result_to_jsonl_bytes

        if result.genome in self.written:
            return
        self._handle.write(result_to_jsonl_bytes(result))
        self._handle.flush()  # per-line durability is the resume contract
        self.written.add(result.genome)

    def close(self) -> None:
        self._handle.close()

    def __enter__(self) -> ShardedJsonlWriter:
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
