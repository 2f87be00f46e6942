r"""DP: band cells the pairs need (counter dp.cells_live) a second of the card's fill kernels (operations named swg_fill*), in billions.

The fill kernels are the largest device operations of both cells, so the
breakdown's ten largest hold every one that takes a measurable share."""

import re

from kbench.spans import count_total

FILL = re.compile(r"\bswg_fill\w*")


def read(run):
    live = count_total(run, "dp.cells_live")
    if not live or run.device is None:
        return None
    fill_s = sum(sec for name, sec in run.device.device_ops if FILL.search(name))
    return live / fill_s / 1e9 if fill_s > 0 else None
