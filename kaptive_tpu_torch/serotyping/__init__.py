r"""Serotyping engine of the port; result models and report rows are the JAX package's."""

from kaptive_tpu_torch._reuse import (
    GeneHits,
    GeneState,
    KaptiveRow,
    LocusPieces,
    Pha4geRow,
    SerotypingProblem,
    SerotypingResult,
)
from kaptive_tpu_torch.serotyping.core import Serotyper

__all__ = [
    "GeneHits",
    "GeneState",
    "KaptiveRow",
    "LocusPieces",
    "Pha4geRow",
    "Serotyper",
    "SerotypingProblem",
    "SerotypingResult",
]
