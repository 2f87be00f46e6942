r"""DP: ms a typed assembly in span dp.collect (the copy back of each sweep, where the host waits for the card)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "dp.collect")
