r"""Map: assemblies chained on the card, a typed assembly (counter map.device_seeded of the stretch's map.seed_device spans; 1.0 where none fell back to the host)."""

from kbench.spans import count_per_asm


def read(run):
    return count_per_asm(run, "map.device_seeded")
