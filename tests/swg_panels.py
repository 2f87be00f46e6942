"""Seeded banded-SWG input panels shared by the port's parity tests.

Every panel is plain numpy, made from a seed, so the JAX package, the port's
plain PyTorch version and the CUDA kernels all see the same bytes.
"""

import numpy as np

AA = b"ARNDCQEGHILKMFPSTWYV"
NT = b"ACGT"


def nt_matrix() -> np.ndarray:
    m = np.full((256, 256), -4, dtype=np.int32)
    for b in NT:  # the panels draw ASCII bases
        m[b, b] = 2
    return m


def blosum_matrix() -> np.ndarray:
    from kaptive_tpu_torch.core.pairwise import blosum62_matrix

    return blosum62_matrix().astype(np.int32)


def random_swg_batch(rng, alphabet: bytes, n_pairs: int, rows_max: int, w_pad: int,
                     *, seeded: bool, tie_heavy: bool = False, max_len: int | None = None):
    """One padded bucket: (q, q_lens, t, t_lens, offsets, k_locals) numpy arrays.

    Pairs mix mutated copies and unrelated sequences; ``tie_heavy`` draws
    short-period repeats so many cells share a score.  Unseeded pairs get the
    aligner's band ``max(20, |len1 - len2| + 1)`` capped to fit ``w_pad``;
    seeded ones a diagonal offset in [-8, 8) and band 20.  The target matrix
    is left-padded by ``t_pad = w_pad + 2`` as the front door requires.
    """
    alpha = np.frombuffer(alphabet, np.uint8)
    max_len = max_len or rows_max
    t_pad = w_pad + 2
    k_cap = (w_pad - 3) // 2
    q = np.zeros((n_pairs, rows_max), np.uint8)
    t = np.zeros((n_pairs, rows_max + 2 * t_pad), np.uint8)
    q_lens = np.zeros(n_pairs, np.int32)
    t_lens = np.zeros(n_pairs, np.int32)
    offs = np.zeros(n_pairs, np.int32)
    kls = np.zeros(n_pairs, np.int32)
    for p in range(n_pairs):
        n = int(rng.integers(0, max_len + 1))
        if tie_heavy:
            period = alpha[rng.integers(0, len(alpha), int(rng.integers(1, 4)))]
            a = np.resize(period, n)
        else:
            a = alpha[rng.integers(0, len(alpha), n)]
        if rng.random() < 0.6:
            b = a.copy()
            for _ in range(int(rng.integers(0, max(1, n // 4)))):
                b[int(rng.integers(0, n))] = alpha[rng.integers(0, len(alpha))]
            cut = int(rng.integers(0, 6))
            b = np.concatenate([alpha[rng.integers(0, len(alpha), cut)], b])[:max_len]
        else:
            b = alpha[rng.integers(0, len(alpha), int(rng.integers(0, max_len + 1)))]
        q[p, : len(a)] = a
        t[p, t_pad : t_pad + len(b)] = b
        q_lens[p], t_lens[p] = len(a), len(b)
        if seeded:
            offs[p] = int(rng.integers(-8, 8))
            kls[p] = min(20, k_cap)
        else:
            kls[p] = min(max(20, abs(len(a) - len(b)) + 1), k_cap)
    return q, q_lens, t, t_lens, offs, kls


def _padded_bucket(pairs, rows_max: int, w_pad: int, k_local: int):
    """(q, q_lens, t, t_lens, offsets, k_locals) of (query, target) byte pairs, seeded on diagonal 0."""
    t_pad = w_pad + 2
    n = len(pairs)
    q = np.zeros((n, rows_max), np.uint8)
    t = np.zeros((n, rows_max + 2 * t_pad), np.uint8)
    for p, (a, b) in enumerate(pairs):
        q[p, : len(a)] = np.frombuffer(a, np.uint8)
        t[p, t_pad : t_pad + len(b)] = np.frombuffer(b, np.uint8)
    lens = [np.array([len(x) for x in side], np.int32) for side in zip(*pairs)]
    return q, lens[0], t, lens[1], np.zeros(n, np.int32), np.full(n, k_local, np.int32)


def _random_bytes(rng, alphabet: bytes, n: int) -> bytes:
    return np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), n)].tobytes()


def _indel_copy(rng, a: bytes) -> bytes:
    """``a`` with about 3% substitutions, 2% deletions and 2% insertions of 1-3 bases."""
    b = bytearray()
    for c in a:
        r = rng.random()
        if r < 0.02:
            continue  # deletion from the target
        b.append(c if r > 0.05 else NT[rng.integers(0, 4)])
        if r > 0.98:
            b += _random_bytes(rng, NT, int(rng.integers(1, 4)))  # insertion
    return bytes(b)


def _alternating_indels(rng, a: bytes) -> bytes:
    """``a`` with an inserted and a deleted base in turn every four bases: two runs per four bases."""
    b = bytearray()
    for k in range(0, len(a), 4):
        chunk = a[k : k + 4]
        b += _random_bytes(rng, NT, 1) + chunk if (k // 4) % 2 == 0 else chunk[1:]
    return bytes(b)


def cigar_bucket(rng, n_pairs: int = 384, rows_max: int = 1024, w_pad: int = 128):
    """A full-size DNA CIGAR bucket: ``(arrays, matrix, gap_open, gap_extend, rows_max, w_pad)``.

    Pair 0 emits far more than 256 runs (:func:`_alternating_indels` over
    nearly ``rows_max`` bases); the others are indel copies of 100 to
    ``rows_max`` bases, so both BAM ``I`` and ``D`` runs are common.
    """
    a = _random_bytes(rng, NT, rows_max - 16)
    pairs = [(a, _alternating_indels(rng, a)[:rows_max])]
    for _ in range(n_pairs - 1):
        a = _random_bytes(rng, NT, int(rng.integers(100, rows_max + 1)))
        pairs.append((a, _indel_copy(rng, a)[:rows_max]))
    return _padded_bucket(pairs, rows_max, w_pad, 20), nt_matrix(), 4, 2, rows_max, w_pad


def _other_base(*neighbours: int) -> bytes:
    """A base that differs from each of ``neighbours``, so an indel of it has one place to go."""
    return bytes([next(b for b in NT if b not in neighbours)])


def _spaced_indels(rng, n_indels: int, n_swaps: int, seg: int = 6) -> tuple[bytes, bytes]:
    """A (query, target) pair of ``seg``-base matching segments with one single-base event
    between neighbours: ``n_indels`` of them a base present on one side only (query and target
    in turn) and, in the middle of them, ``n_swaps`` a base that differs between the two.  Under
    :func:`harsh_nt_matrix` a differing base aligns as an insertion beside a deletion, so the
    alignment holds ``1 + 2 * n_indels + 3 * n_swaps`` runs, an even count when ``n_swaps`` is odd.
    """
    segs = [_random_bytes(rng, NT, seg) for _ in range(n_indels + n_swaps + 1)]
    q, t = bytearray(segs[0]), bytearray(segs[0])
    swaps = range(n_indels // 2, n_indels // 2 + n_swaps)
    for e, nxt in enumerate(segs[1:]):
        x = _other_base(q[-1], nxt[0])
        if e in swaps:
            q += x
            t += _other_base(q[-2], nxt[0], x[0])
        elif e % 2 == 0:
            q += x
        else:
            t += x
        q += nxt
        t += nxt
    return bytes(q), bytes(t)


def harsh_nt_matrix() -> np.ndarray:
    """DNA scoring whose mismatch (-20) costs more than two one-base gaps (2 x 6)."""
    m = np.full((256, 256), -20, dtype=np.int32)
    for b in NT:
        m[b, b] = 2
    return m


M_RUNS = (31, 32, 33, 64, 65)


def m_run_pairs(rng):
    """For each n in ``M_RUNS`` a pair aligned as ``n M, 1 D, n M, 1 I, 2n M``: diagonal runs
    that end one cell before, at and one cell after the walk's 32-cell stretch, and runs of two
    stretches and more that must come out as one run.  Then two pairs whose walk leaves the
    matrix in the middle of a stretch: the target starts 7 bases in (the walk ends at i = 0,
    j = 7 after 45 diagonal steps) and the query does (j = 0, i = 7)."""
    pairs = []
    for n in M_RUNS:
        s = [_random_bytes(rng, NT, n) for _ in range(4)]
        x, y = _other_base(s[1][-1], s[2][0]), _other_base(s[0][-1], s[1][0])
        pairs.append((s[0] + s[1] + x + s[2] + s[3], s[0] + y + s[1] + s[2] + s[3]))
    tail, lead = _random_bytes(rng, NT, 45), _random_bytes(rng, NT, 7)
    return pairs + [(tail, lead + tail), (lead + tail, tail)]


def cigar_panel(rng, kind: str):
    """A CIGAR-mode bucket: ``(arrays, matrix, gap_open, gap_extend, rows_max, w_pad)``.

    ``m-runs``: :func:`m_run_pairs`; ``gap-runs``: :func:`gap_run_panel` (one gap of 31 to 70
    steps a pair, walks ending at the matrix edge); ``runs-255-256-257``: three pairs of
    exactly 255, 256 and 257 runs (:func:`_spaced_indels` under :func:`harsh_nt_matrix`):
    the last slot filled without overflow, and one run past it, which overwrites slot 255 and
    sets the flag.

    ``nt-indels``: mutated DNA copies with substitutions, insertions and
    deletions; ``protein``: BLOSUM62 pairs; ``overflow``: one pair whose
    alignment alternates an inserted and a deleted base every four bases (far
    more than 256 runs) beside two ordinary pairs; ``no-op``: pairs whose walk
    emits no run (empty query, empty target, nothing that scores) beside one
    that does.
    """
    if kind == "protein":
        return random_swg_batch(rng, AA, 10, 128, 128, seeded=False), blosum_matrix(), 11, 1, 128, 128
    if kind == "m-runs":
        return _padded_bucket(m_run_pairs(rng), 320, 128, 20), nt_matrix(), 4, 2, 320, 128
    if kind == "gap-runs":
        return gap_run_panel(rng, 320, 256), nt_matrix(), 4, 2, 320, 256
    if kind == "runs-255-256-257":
        pairs = [_spaced_indels(rng, 127, 0), _spaced_indels(rng, 126, 1), _spaced_indels(rng, 128, 0)]
        return _padded_bucket(pairs, 1024, 128, 20), harsh_nt_matrix(), 4, 2, 1024, 128
    pairs = []
    if kind == "nt-indels":
        for _ in range(12):
            a = _random_bytes(rng, NT, int(rng.integers(40, 240)))
            pairs.append((a, _indel_copy(rng, a)[:256]))
        return _padded_bucket(pairs, 256, 128, 20), nt_matrix(), 4, 2, 256, 128
    if kind == "overflow":
        a = _random_bytes(rng, NT, 1200)
        b = _alternating_indels(rng, a)
        c = _random_bytes(rng, NT, 300)
        pairs = [(a, b[:1280]), (c, c), (c[:200], _random_bytes(rng, NT, 220))]
        return _padded_bucket(pairs, 1280, 128, 20), nt_matrix(), 4, 2, 1280, 128
    if kind == "no-op":
        c = _random_bytes(rng, NT, 90)
        pairs = [(b"", c), (c, b""), (b"A" * 60, b"C" * 60), (c, c)]
        return _padded_bucket(pairs, 128, 128, 20), nt_matrix(), 4, 2, 128, 128
    raise ValueError(kind)


CIGAR_PANELS = ("nt-indels", "protein", "overflow", "no-op", "m-runs", "gap-runs", "runs-255-256-257")


def best_cell_panel(rows_max: int = 64, w_pad: int = 128):
    """Pairs whose best score is reached in more than one cell, or at the band's
    last row: ``(arrays, expected (best_i, best_j) per pair)``, DNA scoring
    (match 2, mismatch -4, gap 4 + 2 per base), unseeded on diagonal 0.

    The fill keeps the first row that reaches the best score and, inside it,
    the lowest band lane (the lowest column).  Two 12-mers ``S1``, ``S2`` score
    24 each; C and A spacers of unequal length keep them from joining (the
    joined alignment scores 18).

    - ``two rows, later one on a lower lane``: query ``S1 C*9 S2``, target
      ``S1 A*6 S2``: cells (12, 12) and (33, 30); the first row wins although
      the second cell's lane is lower.
    - ``two rows, later one on a higher lane``: spacers swapped: (12, 12) and (30, 33).
    - ``one row``: query ``S1``, target ``S1 A*6 S1``: (12, 12) and (12, 30) in
      one row; the lower lane wins.
    - ``last row``: identical 40-mers, and identical ``rows_max``-mers: the best
      cell is in the query's last row, which is the bucket's last row too.
    - ``q_len above rows_max``: a ``rows_max``-mer whose stated length exceeds
      the bucket's rows: the fill stops at ``rows_max``.
    - ``nothing scores``: no cell above 0: the best cell stays (0, 0).
    """
    s1, s2 = b"ACGTTGCAAGCT", b"GATCCTAGGTCA"
    rng = np.random.default_rng(97)
    full = _random_bytes(rng, NT, rows_max)
    pairs = [
        (s1 + b"C" * 9 + s2, s1 + b"A" * 6 + s2),
        (s1 + b"C" * 6 + s2, s1 + b"A" * 9 + s2),
        (s1, s1 + b"A" * 6 + s1),
        (full[:40], full[:40]),
        (full, full),
        (full, full),
        (b"A" * 30, b"C" * 30),
    ]
    expected = [(12, 12), (12, 12), (12, 12), (40, 40), (rows_max, rows_max), (rows_max, rows_max), (0, 0)]
    arrays = list(_padded_bucket(pairs, rows_max, w_pad, 40))
    arrays[1][5] = rows_max + 50  # the stated query length runs past the bucket's rows
    return tuple(arrays), expected


GAP_RUNS = (31, 32, 33, 40, 64, 70)


def gap_run_panel(rng, rows_max: int = 320, w_pad: int = 256):
    """Pairs whose alignment holds one long gap: for each length in ``GAP_RUNS`` a
    pair with that many extra bases in the query (a vertical run of the walk)
    and one with them in the target (a horizontal run), between two matching
    120-base flanks; then two identical pairs whose walk ends at the matrix
    edge (i = 0 and j = 0 together) and one whose target starts 5 bases in
    (the walk ends at i = 0 with j = 5).  DNA scoring, band 90 on diagonal 0.
    """
    pairs = []
    for n in GAP_RUNS:
        left, right = _random_bytes(rng, NT, 120), _random_bytes(rng, NT, 120)
        extra = _random_bytes(rng, NT, n)
        pairs.append((left + extra + right, left + right))
        pairs.append((left + right, left + extra + right))
    whole = _random_bytes(rng, NT, 200)
    pairs += [(whole, whole), (whole[:33], whole[:33]), (whole, _random_bytes(rng, NT, 5) + whole)]
    return _padded_bucket(pairs, rows_max, w_pad, 90)
