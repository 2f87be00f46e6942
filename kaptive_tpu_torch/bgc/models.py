r"""Parameter bundle persisted by the BGC architectural decoder.

The trainer (``kaptive_tpu_torch/bgc/trainer.py``) emits one of these per database and
the predictor (``kaptive_tpu_torch/bgc/predictor.py``) consumes it read-only, so the
bundle is deliberately dumb: three float32 arrays plus ``.npz`` persistence, with
the field list kept in one table so save/load/validation can never drift apart.

Capability parity with ``kaptive/bgc/models.py:17-76``
(same three parameters, same on-disk ``.npz`` key names so model files are
interchangeable between the two implementations).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# One row per persisted field: (attribute / npz key, required ndim).
_PARAM_TABLE: tuple[tuple[str, int], ...] = (
    ("centroids", 2),  # (n_archetypes, n_features) emission centroids
    ("bg_centroid", 1),  # (n_features,) background emission centroid
    ("transitions", 2),  # (n_states, n_states) log transition matrix
)


class ArchitecturalModel:
    r"""Frozen float32 parameter set for archetype-HMM Viterbi decoding."""

    __slots__ = tuple(name for name, _ in _PARAM_TABLE)

    def __init__(self, centroids, bg_centroid, transitions) -> None:
        given = {"centroids": centroids, "bg_centroid": bg_centroid, "transitions": transitions}
        for name, ndim in _PARAM_TABLE:
            arr = np.ascontiguousarray(given[name], dtype=np.float32)
            if arr.ndim != ndim:
                raise ValueError(f"{name} must be {ndim}-D, got shape {arr.shape}")
            object.__setattr__(self, name, arr)
        if self.centroids.shape[1] != self.bg_centroid.shape[0]:
            raise ValueError(
                f"feature-width mismatch: centroids {self.centroids.shape} "
                f"vs bg_centroid {self.bg_centroid.shape}"
            )
        n_states = self.transitions.shape[0]
        if self.transitions.shape != (n_states, n_states):
            raise ValueError(f"transitions must be square, got {self.transitions.shape}")

    def __setattr__(self, name: str, value) -> None:  # parameters are read-only
        raise AttributeError(f"ArchitecturalModel is frozen (tried to set {name!r})")

    def __repr__(self) -> str:
        dims = ", ".join(f"{name}{getattr(self, name).shape}" for name, _ in _PARAM_TABLE)
        return f"ArchitecturalModel({dims})"

    def save(self, path: str | Path) -> None:
        r"""Write all parameters to a compressed ``.npz`` archive at ``path``."""
        np.savez_compressed(Path(path), **{name: getattr(self, name) for name, _ in _PARAM_TABLE})

    @classmethod
    def load(cls, path: str | Path) -> "ArchitecturalModel":
        r"""Rebuild a bundle from :meth:`save` output (validates dims/widths)."""
        with np.load(Path(path)) as archive:
            missing = [name for name, _ in _PARAM_TABLE if name not in archive.files]
            if missing:
                raise KeyError(f"model archive {path} is missing arrays: {missing}")
            return cls(**{name: archive[name] for name, _ in _PARAM_TABLE})
