r"""Biosynthetic Gene Cluster (BGC) toolkit: annotate, predict, train.

The port of ``kaptive_tpu/bgc`` (capability parity with ``kaptive/bgc``):
ORF calling (the frameshift-tolerant gene HMM, or a vectorised six-frame ORF
finder), protein randstrobe annotation against the database,
bag-of-strobemer featurisation, and an HMM architectural predictor/trainer.
Both Viterbi decodes are hand-written Hopper kernels on a card
(:mod:`kaptive_tpu_torch.ops.viterbi`); emissions are torch ops
(:mod:`kaptive_tpu_torch.bgc.kernels`).
"""

from kaptive_tpu_torch.bgc.annotate import AnnotationResult, Annotator, Genes
from kaptive_tpu_torch.bgc.models import ArchitecturalModel
from kaptive_tpu_torch.bgc.orf import find_orfs
from kaptive_tpu_torch.bgc.predictor import ArchitecturalPredictor, BGCPredictions
from kaptive_tpu_torch.bgc.trainer import ArchitecturalTrainer

__all__ = [
    "AnnotationResult",
    "Annotator",
    "ArchitecturalModel",
    "ArchitecturalPredictor",
    "ArchitecturalTrainer",
    "BGCPredictions",
    "Genes",
    "find_orfs",
]
