r"""Decide: ms a typed assembly in phases type.decide, type.extract and type.finalize (the numpy decision stages)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "type.decide", "type.extract", "type.finalize")
