r"""Port utilities: device selection (:mod:`kaptive_tpu_torch.utils.device`).

Phase timers and pipeline counters are reused from
:mod:`kaptive_tpu.utils.profiling` and :mod:`kaptive_tpu.utils.metrics`.
"""
