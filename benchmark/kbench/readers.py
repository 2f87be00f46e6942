r"""Arithmetic shared by the per-layer readers: phase seconds and device time per assembly typed in the stretch."""

from __future__ import annotations


def phase_ms_per_asm(run, *phases: str) -> float | None:
    r"""Summed seconds of ``phases`` over the stretch, in ms per assembly typed in it;
    ``None`` when the stretch typed nothing or no phase was recorded."""
    if run.stretch_rows <= 0 or not any(p in run.phases for p in phases):
        return None
    return sum(run.phases.get(p, 0.0) for p in phases) * 1e3 / run.stretch_rows


def idle_pct(run) -> float | None:
    r"""Percent of the stretch in which no kernel, copy or memset ran on the card."""
    d = run.device
    if d is None or d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)


def kernel_ms_per_asm(run) -> float | None:
    d = run.device
    if d is None or d.kernel_s <= 0 or run.stretch_rows <= 0:
        return None
    return d.kernel_s * 1e3 / run.stretch_rows
