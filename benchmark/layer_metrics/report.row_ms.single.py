r"""Report: ms a typed assembly in span report.row (KaptiveRow.from_result and its bytes)."""

from kbench.readers import phase_ms_per_asm


def read(run):
    return phase_ms_per_asm(run, "report.row")
