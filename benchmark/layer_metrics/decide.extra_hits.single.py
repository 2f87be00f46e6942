r"""Decide: extra-gene hits kept after the identity cull, a typed assembly (counter decide.extra_hits of the stretch's spans)."""

from kbench.spans import count_per_asm


def read(run):
    return count_per_asm(run, "decide.extra_hits")
