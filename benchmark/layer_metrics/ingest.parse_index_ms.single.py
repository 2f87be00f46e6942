r"""Ingest of one request: ms a typed assembly in phase type.ingest (FASTA parse and contig index)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "type.ingest")
