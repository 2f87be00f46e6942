"""Code-stream panels for the row-compact scan tests (CPU parity and card).

Each panel is a flat (rows * 128,) uint8 code stream made with numpy from a
seed: random bases with sprinkled sentinels and a sentinel tail, contig
boundaries as k-1 sentinel runs, a row count that is a multiple of neither
32 nor 1024, and a 400-base poly-A run whose rows overflow 64 slots.

``EDGE_PANELS`` are the streams a tiled kernel can get wrong: fewer rows than
any tile, nothing but sentinels, and sentinels, a period-2 repeat (ties two
apart) and a poly-A run each laid across a row edge, a 16-base word edge and
every multiple of 4,096 positions (the CUDA kernel's tile).  ``KW_CASES``
are (k, w) pairs other than the default (15, 10), down to the smallest pair
the JAX package's scan takes.
"""

import numpy as np

ROW = 128
K = 15


def random_stream(rng, rows):
    L = rows * ROW
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.integers(0, L, max(L // 1000, 5))] = 4  # sprinkled sentinels
    codes[-64:] = 4  # sentinel tail (bucket padding)
    return codes


def multi_contig(rng, rows=512):
    codes = random_stream(rng, rows)
    for cut in (1000, 30000, 50001):
        codes[cut : cut + K - 1] = 4
    return codes


def poly_a(rng, rows=256):
    codes = random_stream(rng, rows)
    codes[5000:5400] = 0  # every k-mer ties, so every position is selected
    return codes


PANELS = {
    "random-1024": lambda rng: random_stream(rng, 1024),
    "multi-contig-512": multi_contig,
    "odd-rows-1000": lambda rng: random_stream(rng, 1000),
    "poly-a-overflow": poly_a,
}



TILE = 4096  # positions per block of the CUDA kernel (csrc/scan.cu)


def _plain_stream(rng, rows):
    """Random bases with a sentinel tail and nothing else planted."""
    codes = rng.integers(0, 4, rows * ROW).astype(np.uint8)
    codes[-64:] = 4
    return codes


def _edges(rows):
    """Positions of a row edge, a 16-base word edge and every multiple of the tile inside the stream."""
    L = rows * ROW
    return sorted({ROW, 5 * ROW + 16, *range(TILE, L - ROW, TILE)} & set(range(ROW, L - ROW)))


def sentinels_across_edges(rng, rows=72):
    codes = _plain_stream(rng, rows)
    for e in _edges(rows):
        codes[e - 1 : e + 1] = 4  # one sentinel on each side of the edge
    return codes


def period2_across_edges(rng, rows=72):
    codes = _plain_stream(rng, rows)
    for e in _edges(rows):
        codes[e - 40 : e + 40] = np.resize(np.array([0, 1], np.uint8), 80)  # ACAC...: ties two apart
    return codes


def poly_a_across_edges(rng, rows=72):
    codes = _plain_stream(rng, rows)
    for e in _edges(rows):
        codes[e - 100 : e + 100] = 0  # every k-mer ties, every window picks its first position:
        # the rows on both sides of the edge overflow their 64 slots
    return codes


EDGE_PANELS = {
    "one-row": lambda rng: _plain_stream(rng, 1),
    "three-rows": lambda rng: random_stream(rng, 3),
    "all-sentinel": lambda rng: np.full(40 * ROW, 4, np.uint8),
    "sentinels-across-edges": sentinels_across_edges,
    "period-2-across-edges": period2_across_edges,
    "poly-a-across-edges": poly_a_across_edges,
}

# (k, w) other than (15, 10); (1, 1) is the smallest pair, and both packages' scans take it
# (every base is its own window, so every valid position is selected).
KW_CASES = ((11, 5), (16, 32), (1, 1))


# The run-time form of both scans (csrc/scan.cu, scan_rt_kernel): the geometry rt_plan gives a
# block, mirrored here for the numpy model and for the card tests that check the form's range.
ANY_THREADS = 288
ANY_TILE = 4096  # the smallest tile: the one the form's range is decided at
ANY_MAX_K = 1024
ANY_MAX_SMEM = 232448  # the shared memory a block can opt in to on sm_90 (227 KB)
SEG_BYTES = 12  # a block scan's element (hash, position, restart seen): three 32-bit words


def any_plan(k: int, w: int, tile: int = ANY_TILE):
    """``rt_plan``: ``{"hb", "nhw", "ncw", "smem"}`` of a block of ``tile`` positions, None when
    ``(k, w)`` does not fit a block."""
    if not (1 <= k <= ANY_MAX_K and 1 <= w <= 1 << 16):
        return None
    hb = (w - 1 + 31) // 32 * 32
    nhw = -(-(hb + tile + w - 1) // 16)
    ncw = nhw + (k + 15) // 16 + 2
    if nhw * 16 >= 1 << 16:
        return None
    slots = 17 * nhw
    sizes = (4 * slots, 4 * slots, 2 * slots, 4 * ncw, 2 * ncw, ncw, 4 * ncw if k > 32 else 0, tile // 8,
             tile // 8, 2 * (ANY_THREADS // 32) * SEG_BYTES)
    smem = sum((b + 15) // 16 * 16 for b in sizes)
    return None if smem > ANY_MAX_SMEM else {"hb": hb, "nhw": nhw, "ncw": ncw, "smem": smem}


def any_max_w(k: int) -> int:
    """``kts_scan_any_max_w``: the widest window the run-time form takes at ``k`` (0 if none)."""
    lo, hi = 0, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if any_plan(k, mid) else (lo, mid - 1)
    return lo
