r"""DP: ms a typed assembly in phases map.extension_dp and type.protein_dp (the banded SWG sweeps, launch to results on the host)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "map.extension_dp", "type.protein_dp")
