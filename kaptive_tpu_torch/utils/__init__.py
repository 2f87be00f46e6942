r"""Port utilities: device selection (:mod:`kaptive_tpu_torch.utils.device`) and the
build-at-first-use of the CUDA sources (:mod:`kaptive_tpu_torch.utils.nvcc`).

Phase timers and pipeline counters are reused from
:mod:`kaptive_tpu.utils.profiling` and :mod:`kaptive_tpu.utils.metrics`.
"""
