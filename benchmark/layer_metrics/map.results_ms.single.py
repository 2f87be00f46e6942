r"""Map: ms a typed assembly in span map.results (the extension results filtered into each genome's alignments)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "map.results")
