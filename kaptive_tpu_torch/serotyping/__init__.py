r"""Serotyping engine of the port: the ``Serotyper``, its decision logic, result models and report rows."""

from kaptive_tpu_torch.serotyping.core import Serotyper
from kaptive_tpu_torch.serotyping.io import KaptiveRow, Pha4geRow
from kaptive_tpu_torch.serotyping.models import (
    GeneHits,
    GeneState,
    LocusPieces,
    SerotypingProblem,
    SerotypingResult,
)

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
