r"""Core data plane of the port: sequence containers, intervals, alignments, k-mer sketches, pairwise DP.

Host-side orchestration uses vectorised numpy over Structure-of-Arrays
containers; device compute lives in :mod:`kaptive_tpu_torch.ops`.
"""

from kaptive_tpu_torch.core.interval import Interval, Intervals, Strand
from kaptive_tpu_torch.core.seq import BacterialTranslationTable, SeqRecord, Sequences

__all__ = [
    "BacterialTranslationTable",
    "Interval",
    "Intervals",
    "SeqRecord",
    "Sequences",
    "Strand",
]
