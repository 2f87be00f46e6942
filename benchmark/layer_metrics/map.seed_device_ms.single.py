r"""Map: ms a typed assembly in span map.seed_device (seeding on the card: scan, match and chain, and the copy back of counts and chains)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "map.seed_device")
