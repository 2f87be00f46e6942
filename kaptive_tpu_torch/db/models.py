r"""Database metadata schema, phenotype rules, and vectorised phenotype masks.

Capability parity with ``kaptive/db/models.py``:
``DatabaseError`` (:27), ``DatabaseMetadata`` (:39-139), ``Phenotype``
(:142-166), ``Phenotypes`` SoA (:169-307).  The TOML field names and the mask
semantics are fixed by the on-disk database format; the validation here is
schema-table driven rather than hand-unrolled.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import numpy.typing as npt

from kaptive_tpu_torch.core.collections import SoAContainer, as_bytes_array, soa


class DatabaseError(Exception):
    r"""Raised for database loading, metadata validation, or format errors."""


# TOML schema (format contract, ref db/models.py:96-139): key -> coercion for
# the required keys, then keys falling back to a legacy alias + ``{}`` default.
_SCHEMA_COERCE: dict[str, Any] = dict.fromkeys(
    "name keyword genbank organism antigen pathway version doi"
    " owner repo branch contact".split()
)
_SCHEMA_COERCE.update(taxon=int, id_threshold=float)
_SCHEMA_LEGACY = {"phenotype_logic": "logic", "antigenic_units": "units"}


class DatabaseMetadata:
    r"""Validated TOML metadata for a reference database (identity, organism,
    repo provenance, and the phenotype/antigenic rule tables).

    One mapping, attribute-projected; the key roster IS the TOML schema, so
    there is no per-key field declaration anywhere.
    """

    __slots__ = ("_fields",)
    FIELDS = (*_SCHEMA_COERCE, *_SCHEMA_LEGACY)

    def __init__(self, **fields: Any) -> None:
        if gaps := [key for key in self.FIELDS if key not in fields]:
            raise DatabaseError(f"Metadata is missing required field: {gaps[0]!r}")
        self._fields = fields

    def __getattr__(self, name: str) -> Any:
        try:
            return object.__getattribute__(self, "_fields")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DatabaseMetadata) and other._fields == self._fields

    def __repr__(self) -> str:
        return f"DatabaseMetadata({self._fields!r})"

    # Pickled caches may hold this mapping form, the older frozen-slotted
    # dataclass form (a positional LIST of field values, the order below was
    # that dataclass's declaration order), or a generic (dict, slot_dict)
    # two-tuple — accept all three on restore.
    _LEGACY_ORDER = (
        "name", "keyword", "genbank", "organism", "taxon", "antigen",
        "pathway", "version", "id_threshold", "doi", "owner", "repo",
        "branch", "contact", "phenotype_logic", "antigenic_units",
    )

    def __getstate__(self) -> dict:
        return self._fields

    def __setstate__(self, state: Any) -> None:
        if isinstance(state, tuple) and len(state) == 2 and isinstance(state[1], dict):
            state = {**(state[0] or {}), **state[1]}
        elif isinstance(state, (list, tuple)):
            state = dict(zip(self._LEGACY_ORDER, state))
        self._fields = dict(state)

    def to_dict(self) -> dict:
        return dict(self._fields)

    @property
    def parsed_version(self) -> tuple[int, ...]:
        r"""Numeric components of ``version`` for semver-style comparison."""
        return tuple(int(tok) for tok in re.findall(r"\d+", str(self.version)))

    @classmethod
    def from_dict(cls, data: dict) -> DatabaseMetadata:
        if not isinstance(data, dict):
            raise DatabaseError("Metadata must be a dictionary.")
        try:
            fields = {
                key: data[key] if coerce is None else coerce(data[key])
                for key, coerce in _SCHEMA_COERCE.items()
            }
        except KeyError as exc:
            raise DatabaseError(f"Metadata is missing required field: {exc.args[0]!r}")
        except (TypeError, ValueError) as exc:
            raise DatabaseError(f"Metadata has an invalid value type: {exc}")
        for key, legacy in _SCHEMA_LEGACY.items():
            fields[key] = data.get(key, data.get(legacy, {}))
        return cls(**fields)


class Phenotype(NamedTuple):
    r"""One phenotype rule: the loci it applies to, genes that must be present
    (``extra_genes``) or intact (``inactive_genes``), resolution priority, and
    whether the id is appended as a suffix rather than replacing the call.

    Field roster (semantics fixed by the DB rule format): ``id`` then the
    three name-sets, ``priority`` (default 50), ``as_suffix`` (default off).
    """

    id: str
    loci: set
    extra_genes: set
    inactive_genes: set
    priority: int = 50
    as_suffix: bool = False


def _mask2d(rows: Any, dtype: Any) -> npt.NDArray[Any]:
    arr = np.array(rows, dtype=dtype)
    return arr if arr.ndim == 2 else arr.reshape(len(arr), -1)


# Column -> dtype roster for (de)serialisation; matrix columns span rules x
# loci (or rules x gene clusters) and keep 2-D shape even when empty.
_PHENO_DTYPES: dict[str, Any] = {
    "ids": "S32",
    "locus_masks": bool,
    "extra_masks": np.int8,
    "inactive_masks": np.int8,
    "extra_counts": np.int8,
    "priorities": np.int8,
    "as_suffix": bool,
}
_PHENO_MATRICES = frozenset(("locus_masks", "extra_masks", "inactive_masks"))


@dataclass(frozen=True, slots=True)
class Phenotypes(SoAContainer):
    r"""SoA batch of phenotype rules for vectorised evaluation.

    Rows are rules; mask matrices span (rules x loci) and (rules x gene
    clusters) so a whole batch of assemblies evaluates with one einsum.
    Batch protocol derived by :class:`~kaptive_tpu_torch.core.collections.SoAContainer`;
    ``empty``/``from_dict`` are overridden to keep the 2-D mask shapes.
    """

    ids: npt.NDArray[np.bytes_] = soa("S32", kind="bytes")
    locus_masks: npt.NDArray[np.bool_] = soa(bool)
    extra_masks: npt.NDArray[np.int8] = soa(np.int8)
    inactive_masks: npt.NDArray[np.int8] = soa(np.int8)
    extra_counts: npt.NDArray[np.int8] = soa(np.int8)
    priorities: npt.NDArray[np.int8] = soa(np.int8)
    as_suffix: npt.NDArray[np.bool_] = soa(bool)

    @classmethod
    def empty(cls) -> Phenotypes:
        blank = {
            name: np.empty((0, 0) if name in _PHENO_MATRICES else 0, dtype=dt)
            for name, dt in _PHENO_DTYPES.items()
        }
        return cls(**blank)

    @classmethod
    def from_dict(cls, data: dict) -> Phenotypes:
        pool = dict(data)
        pool["extra_masks"] = extra = _mask2d(pool["extra_masks"], np.int8)
        if pool.get("extra_counts") is None:
            pool["extra_counts"] = extra.sum(axis=1) if extra.size else np.empty(0)

        def column(name: str, dt: Any) -> np.ndarray:
            if name == "ids":
                return as_bytes_array(pool[name])
            if name in _PHENO_MATRICES:
                return _mask2d(pool[name], dt)
            return np.array(pool[name], dtype=dt)

        return cls(**{name: column(name, dt) for name, dt in _PHENO_DTYPES.items()})
