r"""Core data plane of the port: the batched pairwise aligner.

Sequence, interval and alignment containers are the JAX package's
(:mod:`kaptive_tpu.core`), reused by import.
"""
