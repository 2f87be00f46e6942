r"""The command line's collection typing: ``stream_type`` over the pool, cycled, at the mix's
``batch_size``, closed loop (the ingest pool reads ahead as fast as the device stage takes
batches); a row is stamped when the stream yields it."""

from __future__ import annotations

import math

from kbench.harness import HarnessError, handle, row_bytes

MAX_RATE = 1500  # assemblies a second the stream's list of requests is sized for


def warm(d) -> None:
    r"""One stream of one batch, then the window's list of requests made."""
    from kaptive_tpu_torch.parallel.pipeline import stream_type

    batch = d.traffic["batch_size"]
    for _ in stream_type(d.serotyper, [handle(a) for a in d.pool[:batch]], batch_size=batch):
        pass
    reps = max(1, math.ceil(MAX_RATE * d.run.seconds / len(d.pool)))
    d.state["handles"] = [handle(d.pool[i % len(d.pool)]) for i in range(reps * len(d.pool))]


def window(d) -> None:
    from kaptive_tpu_torch.parallel.pipeline import stream_type

    run, clock = d.run, d.clock
    n = len(d.pool)
    run.window_start = clock()
    end = run.window_start + run.seconds
    results = stream_type(d.serotyper, d.state["handles"], batch_size=d.traffic["batch_size"])
    try:
        for k, result in enumerate(results):
            row = row_bytes(result)
            now = clock()
            if now > end:
                break
            run.done_at.append(now)
            d.observer.see(k % n, result, row)
            d.stretch.tick(now, len(run.done_at))
        else:
            raise HarnessError("the stream's requests ran out before the window closed")
    finally:
        results.close()
    d.stretch.finish(len(run.done_at))
    del d.state["handles"]
