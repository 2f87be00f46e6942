r"""Genome assembly loading, FASTA I/O, and lazy device-encoded contig batches.

Capability parity with ``kaptive/core/genome.py``:
FASTA reading (:24-87, backed there by the rammappy Rust parser) and
``GenomeAssembly`` (:90-242) with transparent ``.gz``/``.bz2``/``.xz``
decompression and a thread-safe lazily-built mapper index (:177-191).  Here
FASTA parsing is a module-level function backed by the native C++ ``hostio``
parser (``csrc/hostio.cpp``, built at first use), and the lazy index is the
contig minimizer index of :mod:`kaptive_tpu_torch.ops.minimizer`.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import re
import threading
from collections.abc import Iterable, Iterator
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, Any, Self

from kaptive_tpu_torch.core.seq import SeqRecord, Sequences

# Recognised assembly filename shapes (same set the reference accepts).
_FASTA_NAME = re.compile(r"\.(?P<ext>f(asta|a|na|fn|as))(\.(?P<codec>gz|bz2|xz))?$")
_CODECS = {"gz": gzip.open, "bz2": bz2.open, "xz": lzma.open, None: open}


def parse_fasta_bytes(data: bytes) -> list[tuple[str, bytes]]:
    r"""Parse raw FASTA bytes into ``(name, sequence)`` pairs.

    Uses the native C++ parser of :mod:`kaptive_tpu_torch.native.hostio`.
    Names are truncated at the first whitespace (standard FASTA convention,
    matching mapper target names).
    """
    from kaptive_tpu_torch.native import hostio

    return hostio.parse_fasta_bytes(data)


def read_fasta(handle: IO[bytes]) -> list[SeqRecord]:
    r"""Drain a binary FASTA stream into :class:`SeqRecord` rows."""
    return [SeqRecord(id=name, seq=seq) for name, seq in parse_fasta_bytes(handle.read())]


class FastaReader:
    r"""Context-managed FASTA stream iterator (closes the handle on exit)."""

    def __init__(self, handle: IO[bytes]) -> None:
        self._handle = handle
        self._records = iter(read_fasta(handle))

    def __enter__(self) -> Self:
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()

    def close(self) -> None:
        try:
            self._handle.close()
        except Exception:
            pass

    __del__ = close

    def __iter__(self) -> Iterator[SeqRecord]:
        return self._records

    def __next__(self) -> SeqRecord:
        return next(self._records)


@dataclass(slots=True, frozen=True)
class GenomeAssembly:
    r"""Contig container with transparent decompression and a lazy contig minimizer index."""

    id: str
    contigs: Sequences
    id_map: dict[str, int] = field(init=False, repr=False, hash=False, compare=False)
    # one-slot cache + lock for the lazily built device index
    _index_slot: list = field(default_factory=list, init=False, repr=False, hash=False, compare=False)
    _index_lock: threading.Lock = field(
        default_factory=threading.Lock, init=False, repr=False, hash=False, compare=False
    )

    def __post_init__(self) -> None:
        lookup = {name: row for row, name in enumerate(self.contigs.ids)}
        object.__setattr__(self, "id_map", lookup)

    # -- construction ------------------------------------------------------

    @classmethod
    def ensure(cls, genome: Self | str | Path | IO[bytes]) -> Self:
        r"""Coerce an assembly, path, or binary stream into an assembly."""
        if isinstance(genome, cls):
            return genome
        if isinstance(genome, (str, Path)):
            return cls.from_file(genome)
        return cls.from_stream(genome)  # type: ignore[arg-type]

    @classmethod
    def from_file(cls, filepath: str | Path) -> Self:
        path = Path(filepath)
        shape = _FASTA_NAME.search(path.name)
        if shape is None:
            raise NotImplementedError(f"Unsupported format: {path}")
        opener = _CODECS[shape.group("codec")]
        with opener(path, mode="rb") as handle:
            return cls.from_stream(handle, path.name.removesuffix(shape.group()))

    @classmethod
    def from_stream(cls, handle: IO[bytes], id_: str | None = None) -> Self:
        records = read_fasta(handle)
        handle.close()
        return cls.from_records(id_ or getattr(handle, "name", "unknown"), records)

    @classmethod
    def from_records(cls, id_: str, records: Iterable[SeqRecord]) -> Self:
        return cls(id_, Sequences.from_records(list(records)))

    # -- container protocol ------------------------------------------------

    def __len__(self) -> int:
        return len(self.contigs.seqs)

    def __iter__(self) -> Iterator[SeqRecord]:
        return iter(self.contigs)

    def __str__(self) -> str:
        return self.id

    def __getitem__(self, item: str) -> bytes:
        row = self.id_map[item]
        lo = self.contigs.offsets[row]
        return self.contigs.seqs[lo : lo + self.contigs.lengths[row]].tobytes()

    # -- lazy device index -------------------------------------------------

    def get_minimizer_index(self) -> Any:
        r"""Lazily build and cache the contig minimizer index, a
        :class:`~kaptive_tpu_torch.ops.minimizer.ContigIndex`
        (upstream Kaptive's lazy rammappy index, ``genome.py:177-191``)."""
        if not self._index_slot:
            with self._index_lock:
                if not self._index_slot:
                    from kaptive_tpu_torch.ops.minimizer import ContigIndex

                    self._index_slot.append(ContigIndex.build(self.contigs))
        return self._index_slot[0]

    @property
    def minimizer_index(self) -> Any:
        return self._index_slot[0] if self._index_slot else None
