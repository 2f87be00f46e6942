r"""DP: percent of the band cells launched that the pairs need (counters dp.cells_live over dp.cells_launched, both sweeps)."""

from kbench.spans import count_total


def read(run):
    live, launched = count_total(run, "dp.cells_live"), count_total(run, "dp.cells_launched")
    if not live or not launched:
        return None
    return 100.0 * live / launched
