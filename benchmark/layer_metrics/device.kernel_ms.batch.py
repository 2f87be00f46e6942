r"""Device: profiler kernel time a typed assembly, in ms."""

from kbench.readers import kernel_ms_per_asm


def read(run):
    return kernel_ms_per_asm(run)
