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
    from kaptive_tpu.core.pairwise import blosum62_matrix

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


def cigar_panel(rng, kind: str):
    """A CIGAR-mode bucket: ``(arrays, matrix, gap_open, gap_extend, rows_max, w_pad)``.

    ``nt-indels``: mutated DNA copies with substitutions, insertions and
    deletions; ``protein``: BLOSUM62 pairs; ``overflow``: one pair whose
    alignment alternates an inserted and a deleted base every four bases (far
    more than 256 runs) beside two ordinary pairs; ``no-op``: pairs whose walk
    emits no run (empty query, empty target, nothing that scores) beside one
    that does.
    """
    if kind == "protein":
        return random_swg_batch(rng, AA, 10, 128, 128, seeded=False), blosum_matrix(), 11, 1, 128, 128
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


CIGAR_PANELS = ("nt-indels", "protein", "overflow", "no-op")
