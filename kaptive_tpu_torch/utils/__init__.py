r"""Port utilities: device selection (:mod:`kaptive_tpu_torch.utils.device`), the
build-at-first-use of the CUDA sources (:mod:`kaptive_tpu_torch.utils.nvcc`),
phase timers and device traces (:mod:`kaptive_tpu_torch.utils.profiling`),
pipeline counters (:mod:`kaptive_tpu_torch.utils.metrics`) and the loader of
state pickled by the JAX package (:mod:`kaptive_tpu_torch.utils.state`).
"""

from kaptive_tpu_torch.utils.profiling import (  # noqa: F401
    device_trace,
    phase_report,
    phase_timer,
    phases_enabled,
    reset_phases,
)
