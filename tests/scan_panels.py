"""Code-stream panels for the row-compact scan tests (CPU parity and card).

Each panel is a flat (rows * 128,) uint8 code stream made with numpy from a
seed: random bases with sprinkled sentinels and a sentinel tail, contig
boundaries as k-1 sentinel runs, a row count that is a multiple of neither
32 nor 1024, and a 400-base poly-A run whose rows overflow 64 slots.
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

