r"""Protocol contracts for Structure-of-Arrays (SoA) batched containers.

Capability parity with ``kaptive/core/collections.py:20-92``:
``BatchedContainer`` (len/getitem/empty/concat) and ``RaggedArrayContainer``
(adds ``offsets``/``lengths``).  These protocols govern every host-side SoA
container in kaptive-tpu; the device side exchanges only the flat arrays.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable
from typing import Any, Protocol, Self, TypeVar

import numpy as np
import numpy.typing as npt

T = TypeVar("T", covariant=True)
S = TypeVar("S", bound="BatchedContainer[Any, Any]")


class BatchedContainer(Protocol[T, S]):
    r"""Contract for SoA batched containers: ``len``, indexing, ``empty``, ``concat``."""

    def __len__(self) -> int: ...

    def __getitem__(self, item: int | slice | npt.NDArray[Any] | list[Any]) -> T | S: ...

    @classmethod
    def empty(cls) -> Self: ...

    @classmethod
    def concat(cls, batches: Iterable[Self]) -> Self: ...


class RaggedArrayContainer(BatchedContainer[T, S], Protocol[T, S]):
    r"""Contract for ragged SoA containers storing variable-length data in flat arrays."""

    offsets: npt.NDArray[np.int32]
    lengths: npt.NDArray[np.int32]


def as_bytes_array(val: Any) -> npt.NDArray[np.bytes_]:
    r"""Encode strings/bytes to a fixed-width bytes array sized to the data.

    Widths adapt to the data (the reference hardcodes S32/S10/S64 and silently
    truncates long gene ids / cluster names / products).
    """
    if isinstance(val, np.ndarray) and val.dtype.kind in ("S", "a"):
        return val
    items = list(val) if not isinstance(val, np.ndarray) else val.tolist()
    encoded = [x.encode("utf-8") if isinstance(x, str) else bytes(x) for x in items]
    if not encoded:
        return np.empty(0, dtype="S1")
    return np.array(encoded, dtype=np.bytes_)


def soa(
    spec: Any = None,
    *,
    kind: str = "array",
    default: Any = dataclasses.MISSING,
    optional: bool = False,
):
    r"""Declare one field of a :class:`SoAContainer` dataclass.

    ``kind`` selects the field's batch behaviour and ``spec`` parameterises it:

    - ``"array"`` (default): a per-row numpy array; ``spec`` is its dtype.
    - ``"bytes"``: a per-row fixed-width bytes array; construction coerces
      str/bytes inputs via :func:`as_bytes_array`, ``to_dict`` decodes UTF-8.
    - ``"container"``: a nested batched container; ``spec`` is its class
      (indexed / concatenated / dict-round-tripped recursively).
    - ``"shared"``: a batch-level value (a vocabulary tuple, a name) carried
      through indexing unchanged; ``concat`` requires it equal across inputs;
      ``spec`` is the value ``empty()`` uses.

    ``optional`` marks the field as defaultable in ``from_dict`` (older
    serialisations may omit it); required fields raise ``KeyError`` when
    missing so truncated/corrupt records fail loudly instead of silently
    constructing ragged-inconsistent containers.
    """
    kw: dict[str, Any] = {
        "metadata": {"soa_kind": kind, "soa_spec": spec, "soa_optional": optional}
    }
    if default is not dataclasses.MISSING:
        kw["default"] = default
    return dataclasses.field(**kw)


class SoAContainer:
    r"""Mixin deriving the :class:`BatchedContainer` protocol from field metadata.

    Dataclasses declare each field with :func:`soa`; the mixin derives
    ``__len__``, ``__getitem__`` (int -> one-row view, slice/mask/index-array
    -> sub-batch), ``empty``, ``concat``, ``to_dict`` and ``from_dict`` from
    the declarations, so containers carry no per-field boilerplate.
    Subclasses may still override any piece (e.g. a scalar record view for
    integer indexing) and delegate the rest to the mixin.
    """

    __slots__ = ()

    @classmethod
    def _soa_spec(cls) -> tuple[tuple[tuple[str, str, Any], ...], tuple[tuple[str, Any], ...]]:
        spec = cls.__dict__.get("_soa_spec_cache")
        if spec is None:
            rows: list[tuple[str, str, Any]] = []
            shared: list[tuple[str, Any]] = []
            optional: set[str] = set()
            for f in dataclasses.fields(cls):  # type: ignore[arg-type]
                kind = f.metadata.get("soa_kind", "array")
                fspec = f.metadata.get("soa_spec")
                if f.metadata.get("soa_optional"):
                    optional.add(f.name)
                if kind == "shared":
                    shared.append((f.name, fspec))
                else:
                    rows.append((f.name, kind, fspec))
            spec = (tuple(rows), tuple(shared))
            cls._soa_spec_cache = spec  # type: ignore[attr-defined]
            cls._soa_optional_cache = frozenset(optional)  # type: ignore[attr-defined]
        return spec

    @classmethod
    def _soa_optional(cls) -> frozenset[str]:
        cls._soa_spec()
        return cls.__dict__.get("_soa_optional_cache", frozenset())

    def __post_init__(self) -> None:
        for name, kind, _ in self._soa_spec()[0]:
            if kind == "bytes":
                val = getattr(self, name)
                if not (isinstance(val, np.ndarray) and val.dtype.kind in ("S", "a")):
                    object.__setattr__(self, name, as_bytes_array(val))

    def __len__(self) -> int:
        rows, _ = self._soa_spec()
        return len(getattr(self, rows[0][0]))

    def __getitem__(self, item: Any) -> Self:
        if isinstance(item, (int, np.integer)):
            n = len(self)
            if item < 0:
                item += n
            if not 0 <= item < n:
                raise IndexError("Batch index out of range")
            item = slice(item, item + 1)
        rows, shared = self._soa_spec()
        kw = {name: getattr(self, name)[item] for name, _, _ in rows}
        kw.update({name: getattr(self, name) for name, _ in shared})
        return type(self)(**kw)

    @classmethod
    def empty(cls) -> Self:
        rows, shared = cls._soa_spec()
        kw: dict[str, Any] = {}
        for name, kind, fspec in rows:
            if kind == "container":
                kw[name] = fspec.empty()
            elif kind == "bytes":
                kw[name] = np.empty(0, dtype=fspec if fspec is not None else "S1")
            else:
                kw[name] = np.empty(0, dtype=fspec)
        kw.update({name: fspec for name, fspec in shared})
        return cls(**kw)

    @classmethod
    def concat(cls, batches: Iterable[Self]) -> Self:
        batches_list = list(batches)
        if not batches_list:
            return cls.empty()
        rows, shared = cls._soa_spec()
        kw: dict[str, Any] = {}
        for name, kind, fspec in rows:
            vals = [getattr(b, name) for b in batches_list]
            kw[name] = fspec.concat(vals) if kind == "container" else np.concatenate(vals)
        for name, _ in shared:
            first = getattr(batches_list[0], name)
            if any(getattr(b, name) != first for b in batches_list[1:]):
                raise ValueError(
                    f"Cannot concatenate batches with mismatched '{name}' values"
                )
            kw[name] = first
        return cls(**kw)

    def to_dict(self) -> dict[str, Any]:
        rows, shared = self._soa_spec()
        d: dict[str, Any] = {}
        for name, kind, _ in rows:
            val = getattr(self, name)
            if kind == "bytes":
                d[name] = np.char.decode(val, "utf-8").tolist()
            elif kind == "container":
                d[name] = val.to_dict()
            else:
                d[name] = val
        d.update({name: getattr(self, name) for name, _ in shared})
        return d

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> Self:
        rows, shared = cls._soa_spec()
        optional = cls._soa_optional()
        kw: dict[str, Any] = {}
        for name, kind, fspec in rows:
            # Required columns raise KeyError when absent — a truncated or
            # corrupt record must fail loudly, not build a ragged container.
            val = data.get(name) if name in optional else data[name]
            if kind == "container":
                kw[name] = fspec.from_dict(val) if val is not None else fspec.empty()
            elif kind == "bytes":
                kw[name] = as_bytes_array(val if val is not None else [])
            else:
                kw[name] = np.array(val if val is not None else [], dtype=fspec)
        kw.update({name: data.get(name, fspec) for name, fspec in shared})
        return cls(**kw)


def cumulative_offsets(lengths: npt.NDArray[np.integer]) -> npt.NDArray[np.int32]:
    r"""Exclusive prefix sum of ``lengths`` as int32 offsets into a flat array."""
    offsets = np.zeros(len(lengths), dtype=np.int32)
    if len(lengths) > 1:
        np.cumsum(lengths[:-1], out=offsets[1:])
    return offsets


def ragged_gather_indices(
    starts: npt.NDArray[np.integer],
    lengths: npt.NDArray[np.integer],
    steps: npt.NDArray[np.integer] | None = None,
) -> tuple[npt.NDArray[np.int64], npt.NDArray[np.int32], npt.NDArray[np.int32]]:
    r"""Build flat gather indices for ragged extraction without per-item Python loops.

    For item ``i`` the produced indices are ``starts[i] + step_i * (0..lengths[i]-1)``.
    Replaces the per-element loops of the reference's Numba ragged kernels
    (``kaptive/core/seq.py:612-668``) with one vectorised gather.

    Returns:
        (flat_indices, out_offsets, out_lengths)
    """
    out_lengths = np.asarray(lengths, dtype=np.int32)
    out_offsets = cumulative_offsets(out_lengths)
    total = int(out_lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), out_offsets, out_lengths
    within = np.arange(total, dtype=np.int64) - np.repeat(
        out_offsets.astype(np.int64), out_lengths
    )
    base = np.repeat(np.asarray(starts, dtype=np.int64), out_lengths)
    if steps is None:
        return base + within, out_offsets, out_lengths
    step = np.repeat(np.asarray(steps, dtype=np.int64), out_lengths)
    return base + step * within, out_offsets, out_lengths


def group_leaders(
    group_keys: npt.NDArray[np.integer],
    rank_columns: tuple[npt.NDArray[Any], ...],
) -> npt.NDArray[np.int64]:
    r"""Row index of the single top-ranked row per distinct group key.

    Rows sharing a group key are ranked by ``rank_columns`` in order (larger
    wins); any remaining tie goes to the earliest row.  Returns leader row
    indices ordered by ascending group key.  Callers must pass signed/float
    rank columns (unsigned dtypes would wrap under negation).
    """
    n = len(group_keys)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    sort_keys = tuple(-np.asarray(c) for c in reversed(rank_columns)) + (group_keys,)
    ranked = np.lexsort(sort_keys)
    at_front = np.ones(n, dtype=bool)
    at_front[1:] = group_keys[ranked][1:] != group_keys[ranked][:-1]
    return ranked[at_front].astype(np.int64)
