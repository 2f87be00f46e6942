"""Seeded inputs at the edges of the kernels' input range, shared by the CPU parity tests,
the numpy models and the card tests.

Every panel is plain numpy made from a seed, so the JAX package, the port's
plain PyTorch forms and the CUDA kernels all see the same bytes:

- the unseeded protein pair whose band lands in the ``w_pad`` 32,768 bucket
  (a 150-residue query cut at residue 1,000 of a random 4,300-residue
  protein: BLOSUM62 gives score 849, 150 matches, q_start 0, t_start 1,000);
- substitution matrices whose scores leave int8 (BLOSUM62 x 20, and a
  nucleotide matrix with match 100,000 and mismatch -200,000);
- buckets whose filled cells span the whole band, so that they cross every
  slice of the fill's cluster form;
- code streams for the scans at wide windows and long k-mers: random bases
  with a sentinel run, a poly-A run (every k-mer ties) and a period-2 repeat
  (ties two apart).
"""

import numpy as np
from swg_panels import AA, NT, blosum_matrix

F7_SEED = 90  # the protein whose cut query scores 849
F7_W_PAD = 32768  # plan_swg_buckets' width for a band of 2 * 4,151 + 3 lanes
F7_EXPECTED = {"scores": 849, "matches": 150, "q_starts": 0, "t_starts": 1000}


def f7_pair(seed: int = F7_SEED) -> tuple[bytes, bytes]:
    """(query, target): residues 1,000 .. 1,149 of a random 4,300-residue protein, and the protein."""
    protein = np.frombuffer(AA, np.uint8)[np.random.default_rng(seed).integers(0, len(AA), 4300)]
    return protein[1000:1150].tobytes(), protein.tobytes()


def f7_bucket(rows_max: int = 256, n_pairs: int = 1):
    """The padded bucket ``PairwiseAligner`` builds for the unseeded F7 pair (offset 0, band
    ``max(20, |150 - 4300| + 1)`` = 4,151, ``w_pad`` 32,768), with ``rows_max`` rows (the aligner
    plans 16,384; rows past the query's 150 are never filled) and ``n_pairs - 1`` empty pairs:
    ``(q, q_lens, t, t_lens, offsets, k_locals)``."""
    query, target = f7_pair()
    t_pad = F7_W_PAD + 2
    q = np.zeros((n_pairs, rows_max), np.uint8)
    t = np.zeros((n_pairs, rows_max + 2 * t_pad), np.uint8)
    q[0, : len(query)] = np.frombuffer(query, np.uint8)
    t[0, t_pad : t_pad + len(target)] = np.frombuffer(target, np.uint8)
    q_lens = np.zeros(n_pairs, np.int32)
    t_lens = np.zeros(n_pairs, np.int32)
    q_lens[0], t_lens[0] = len(query), len(target)
    k_locals = np.ones(n_pairs, np.int32)
    k_locals[0] = max(20, abs(len(query) - len(target)) + 1)
    return q, q_lens, t, t_lens, np.zeros(n_pairs, np.int32), k_locals


def scaled_blosum(factor: int = 20) -> np.ndarray:
    """BLOSUM62 x ``factor`` as int32: scores -2,560 .. 220 at 20 (bytes outside the alphabet
    score -128 x factor)."""
    return blosum_matrix() * np.int32(factor)


def big_nt_matrix(match: int = 100_000, mismatch: int = -200_000) -> np.ndarray:
    """A nucleotide matrix far outside int8: ``match`` on equal ASCII bases, ``mismatch`` elsewhere."""
    m = np.full((256, 256), mismatch, dtype=np.int32)
    for b in NT:
        m[b, b] = match
    return m


# Matrices outside int8, each with its gap costs (gap_open, gap_extend).
WIDE_MATRICES = {
    "blosum62-x20": (AA, scaled_blosum, 220, 20),
    "nt-100000": (NT, big_nt_matrix, 400_000, 100_000),
}


def wide_band_panel(seed: int, alphabet, B: int, rows_max: int, w_pad: int):
    """Pairs whose filled cells span the whole band: short repeat-rich queries (one with a stated
    length past the bucket's rows) against targets of a quarter to a half of ``w_pad`` at diagonal
    offset 0 (the band's upper half) or far below it (the lower half), bands nearly ``w_pad`` wide,
    and an empty pair last: ``(q, q_lens, t, t_lens, offsets, k_locals)``."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, np.uint8)
    t_pad, k_pad = w_pad + 2, (w_pad - 3) // 2
    q = np.zeros((B, rows_max), np.uint8)
    t = np.zeros((B, rows_max + 2 * t_pad), np.uint8)
    q_lens, t_lens, offsets, k_locals = (np.zeros(B, np.int32) for _ in range(4))
    k_locals[-1] = 1
    for p in range(B - 1):
        period = alpha[rng.integers(0, len(alpha), int(rng.integers(1, 4)))]
        n, m = int(rng.integers(rows_max // 2, rows_max + 1)), int(rng.integers(max(1, k_pad // 2), k_pad + 1))
        a, b = np.resize(period, n), np.resize(period, m)
        a[rng.random(n) < 0.1] = alpha[rng.integers(0, len(alpha))]
        b[rng.random(m) < 0.1] = alpha[rng.integers(0, len(alpha))]
        q[p, :n], t[p, t_pad: t_pad + m] = a, b
        q_lens[p] = n + (5 if p == 1 else 0)
        t_lens[p] = m
        offsets[p] = 0 if p % 2 == 0 else -int(rng.integers(k_pad // 2, k_pad + 1))
        k_locals[p] = max(1, k_pad - int(rng.integers(0, 8)))
    return q, q_lens, t, t_lens, offsets, k_locals


def scan_stream(rng, L: int) -> np.ndarray:
    """Random bases with a 20-sentinel run, a 200-base poly-A run and a 120-base period-2 repeat."""
    codes = rng.integers(0, 4, L).astype(np.uint8)
    a, b, c = (int(x) for x in np.sort(rng.choice(np.arange(0, L - 220, 7), 3, replace=False)))
    codes[a : a + 20] = 4
    codes[b : b + 200] = 0
    codes[c : c + 120] = np.resize(np.array([1, 2], np.uint8), 120)
    return codes


def flat_panel(seed: int = 9, L: int = 3000) -> np.ndarray:
    """One (L,) code stream for the flat scan."""
    return scan_stream(np.random.default_rng(seed), L)


def rowcompact_panel(seed: int = 5, rows: int = 24, B: int = 2) -> np.ndarray:
    """(B, rows + 16, 128) sentinel-padded code streams for the row-compact scan."""
    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any

    rng = np.random.default_rng(seed)
    return np.stack([pad_codes_for_scan_any(scan_stream(rng, rows * 128)) for _ in range(B)])


WIDE_WINDOWS = (33, 64, 200, 1000, 1100)  # past the tiled kernels' 32, and past the 1,024-position halo
LONG_KMERS = (17, 20, 31)  # past the tiled kernels' 16
