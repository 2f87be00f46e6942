r"""Device: percent of the traced stretch in which no kernel, copy or memset ran (union of the profiler's device intervals)."""

from kbench.readers import idle_pct


def read(run):
    return idle_pct(run)
