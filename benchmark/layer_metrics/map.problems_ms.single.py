r"""Map: ms a typed assembly in span map.problems (the extension problems built from the chains and merged into one sweep's input)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "map.problems")
