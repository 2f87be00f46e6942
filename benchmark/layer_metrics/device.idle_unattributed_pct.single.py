r"""Device: percent of the stretch's idle card time in which no program span but type.request is open.

The time no such span is open, on any thread, over the idle time of the
profiler's device intervals: every launch of a request is collected inside
its dp.collect span, so the card runs nothing while no span is open."""

from kbench.spans import unattributed_s


def read(run):
    glue, d = unattributed_s(run), run.device
    if glue is None or d is None or d.busy_s <= 0 or d.window_s <= d.busy_s:
        return None
    return 100.0 * glue / (d.window_s - d.busy_s)
