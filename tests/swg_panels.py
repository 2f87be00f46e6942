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
