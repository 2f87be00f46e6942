r"""One client in a closed loop: each assembly's FASTA bytes through ``Serotyper.batch([one])``
to its report row, the next sent when the row is out; every layer of a request in series."""

from __future__ import annotations

from kbench.harness import handle, row_bytes


def warm(d) -> None:
    r"""Two requests, as the window sends them (the warm-up typed the program's own genomes)."""
    for asm in d.pool[:2]:
        d.serotyper.batch([handle(asm)])


def window(d) -> None:
    run, clock = d.run, d.clock
    n = len(d.pool)
    run.window_start = clock()
    end = run.window_start + run.seconds
    k = 0
    while (now := clock()) < end:
        d.stretch.tick(now, len(run.done_at))
        h = handle(d.pool[k % n])
        t_in = clock()
        [result] = d.serotyper.batch([h])
        row = row_bytes(result)
        t_out = clock()
        if d.stretch.enabled:
            run.spans.append((t_in, t_out, "request"))
        run.done_at.append(t_out)
        run.turnaround_s.append(t_out - t_in)
        d.observer.see(k % n, result, row)
        k += 1
    d.stretch.finish(len(run.done_at))
