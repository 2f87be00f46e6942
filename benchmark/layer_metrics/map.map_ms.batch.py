r"""Map: ms a typed assembly in phase type.map (the map thread's wall, chains and extension problems with their DP)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "type.map")
