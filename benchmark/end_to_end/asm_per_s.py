r"""Assemblies whose report row was produced inside the window, over the window's seconds."""

from kbench.timing import rate


def read(run):
    return rate(run.done_at, run.window_start, run.seconds)
