r"""Map: chains that became extension problems, a typed assembly (counter map.chains of the stretch's spans)."""

from kbench.spans import count_per_asm


def read(run):
    return count_per_asm(run, "map.chains")
