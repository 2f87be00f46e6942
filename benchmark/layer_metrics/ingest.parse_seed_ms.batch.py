r"""Ingest pool: thread-ms a typed assembly in phase ingest.parse_pack (parse, contig index, host seed and chain), summed over the pool's threads."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "ingest.parse_pack")
