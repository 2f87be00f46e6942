r"""Decide: ms a typed assembly in span decide.cull (the greedy overlap cull of the batch's hits, inside type.decide)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "decide.cull")
