r"""Map: ms a typed assembly in span map.chain (the anchor arrays and numpy chaining, chain_anchors)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "map.chain")
