r"""95th percentile (nearest rank) of every request's turnaround in the window, FASTA handed in to row out, in ms."""

from kbench.timing import percentile


def read(run):
    return percentile(run.turnaround_s, 95.0) * 1e3
