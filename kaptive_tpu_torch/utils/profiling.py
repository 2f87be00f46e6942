r"""Device trace capture (counterpart of ``kaptive_tpu.utils.profiling.device_trace``).

:func:`phase_timer` and :func:`phase_report` are the JAX package's, reused by
import (they are plain wall-clock timers).  Its ``device_trace`` wraps
``jax.profiler.trace``; the port's wraps ``torch.profiler`` and writes a
Chrome trace (``chrome://tracing`` or Perfetto) into ``$KAPTIVE_TRACE_DIR``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from kaptive_tpu.utils.profiling import phase_report, phase_timer

__all__ = ["device_trace", "phase_report", "phase_timer"]


@contextmanager
def device_trace():
    r"""Record a ``torch.profiler`` trace of the block when ``$KAPTIVE_TRACE_DIR`` is set.

    The variable names the directory; without it this does nothing.  CPU activity is always recorded, CUDA activity
    when a card is present.  The trace is written as
    ``kaptive_trace_<pid>_<time>.json``; the path is returned by the context.
    """
    trace_dir = os.environ.get("KAPTIVE_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    out_dir = Path(trace_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"kaptive_trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))
