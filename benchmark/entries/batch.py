r"""One client in a closed loop over batches: the next ``batch_size`` assemblies of the pool,
cycled, through one ``Serotyper.batch`` call to their report rows, the next batch sent when
every row of this one is out.  Each row is stamped when its batch's rows are out, so its
turnaround is the batch's wall time; no stream, pool of workers or helper thread."""

from __future__ import annotations

from kbench.harness import HarnessError, handle, row_bytes


def _indices(d, k: int) -> list[int]:
    n = len(d.pool)
    return [(k + j) % n for j in range(d.traffic["batch_size"])]


def warm(d) -> None:
    r"""One batch of ``batch_size``, as the window sends them.  A batch that takes more than half
    the window leaves too few in it to measure a rate: the run stops there, with no result."""
    t0 = d.clock()
    d.serotyper.batch([handle(d.pool[i]) for i in _indices(d, 0)])
    took = d.clock() - t0
    if took > d.run.seconds / 2:
        raise HarnessError(f"one batch of {d.traffic['batch_size']} took {took:.1f} s, more than half "
                           f"the {d.run.seconds:g} s window")


def window(d) -> None:
    run, clock = d.run, d.clock
    run.window_start = clock()
    end = run.window_start + run.seconds
    k = 0
    while (now := clock()) < end:
        d.stretch.tick(now, len(run.done_at))
        idx = _indices(d, k)
        handles = [handle(d.pool[i]) for i in idx]
        t_in = clock()
        results = d.serotyper.batch(handles)
        rows = [row_bytes(r) for r in results]
        t_out = clock()
        if d.stretch.enabled:
            run.spans.append((t_in, t_out, "request"))
        for i, result, row in zip(idx, results, rows):
            run.done_at.append(t_out)
            run.turnaround_s.append(t_out - t_in)
            d.observer.see(i, result, row)
        k += len(idx)
    d.stretch.finish(len(run.done_at))
