r"""Decide: ms a typed assembly in span type.phenotype (the active-cluster mask and the phenotype rules, inside type.finalize)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "type.phenotype")
