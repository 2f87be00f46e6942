r"""Map: ms a typed assembly in span map.seed (the C seed, hostio.seed_anchors: minimizer scan and gene-table match)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "map.seed")
