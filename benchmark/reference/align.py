r"""Plain alignment arithmetic for the reference: translation, BLOSUM62 and
affine-gap dynamic programming, written from the textbook definitions.

Gotoh's recurrences with a gap of length ``L`` costing ``open + L * extend``:

    F[i,j] = max(H[i-1,j] - open - extend, F[i-1,j] - extend)
    E[i,j] = max(H[i,j-1] - open - extend, E[i,j-1] - extend)
    H[i,j] = max(0 (local only), H[i-1,j-1] + s(q_i, t_j), E[i,j], F[i,j])

One step a query row, batched over pairs, on whatever device the tensors
live on.  ``E`` of a row is a prefix maximum: opening a gap from a cell
that itself ends a horizontal gap never beats extending that gap, so ``E``
can be taken from the row without it (``torch.cummax``).  Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 28)

# NCBI BLOSUM62 over ARNDCQEGHILKMFPSTWYVBJZX* (public values).
_B62_ALPHABET = b"ARNDCQEGHILKMFPSTWYVBJZX*"
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1 -1 -1 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1 -2  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  4 -3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4 -3  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -1 -3 -1 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0 -2  4 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1 -3  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -4 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0 -3  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3  3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4  3 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0 -3  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3  2 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3  0 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -3 -1 -1 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0 -2  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -2 -2 -1 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -1 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3  2 -2 -1 -4
-2 -1  4  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4 -3  0 -1 -4
-1 -2 -3 -3 -1 -2 -3 -4 -3  3  3 -3  2  0 -3 -2 -1 -2 -1  2 -3  3 -3 -1 -4
-1  0  0  1 -3  4  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -2 -2 -2  0 -3  4 -1 -4
-1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""
PROTEIN_ALPHABET = _B62_ALPHABET
BLOSUM62 = np.array(_B62.split(), dtype=np.int32).reshape(25, 25)
PROTEIN_GAP = (11, 1)  # Kaptive's protein open / extend

NT_MATRIX = np.full((4, 4), -4, dtype=np.int32)  # minimap2's -A2 -B4
np.fill_diagonal(NT_MATRIX, 2)
NT_GAP = (4, 2)  # minimap2's -O4 -E2

# The standard genetic code (NCBI table 11 differs only in its start codons),
# codons in TCAG order.
_AA = b"FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_TCAG = np.array([2, 1, 3, 0], dtype=np.int64)  # code (A, C, G, T = 0..3) -> its digit in TCAG order
STOP = ord("*")


def translate(codes: np.ndarray, to_stop: bool) -> bytes:
    r"""Amino acids of the whole codons of ``codes`` (bases as 0..3), cut before
    the first stop when ``to_stop``."""
    n = len(codes) // 3
    if n == 0:
        return b""
    c = _TCAG[codes[: 3 * n].reshape(n, 3).astype(np.int64)]
    aa = np.frombuffer(_AA, np.uint8)[c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]]
    if to_stop:
        stops = np.flatnonzero(aa == STOP)
        if len(stops):
            aa = aa[: stops[0]]
    return aa.tobytes()


def protein_codes(protein: bytes) -> np.ndarray:
    lut = np.full(256, 23, dtype=np.uint8)  # anything else reads as X
    lut[np.frombuffer(PROTEIN_ALPHABET, np.uint8)] = np.arange(25, dtype=np.uint8)
    return lut[np.frombuffer(protein, np.uint8)]


def _pad(seqs: list[np.ndarray], fill: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    width = max(1, max(len(s) for s in seqs))
    out = np.full((len(seqs), width), fill, dtype=np.int64)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int64, device=device)
    return torch.from_numpy(out).to(device), lens


def affine_scores(queries, targets, matrix: np.ndarray, gap: tuple[int, int], local: bool, device) -> np.ndarray:
    r"""Best local (``local``) or global alignment score of each
    ``(queries[p], targets[p])``; sequences are code arrays indexing ``matrix``."""
    if not queries:
        return np.zeros(0, dtype=np.int64)
    go, ge = gap
    n_codes = matrix.shape[0]
    q, q_len = _pad(queries, n_codes, device)
    t, t_len = _pad(targets, n_codes, device)
    big = np.full((n_codes + 1, n_codes + 1), NEG // 4, dtype=np.int64)  # padding never aligns
    big[:n_codes, :n_codes] = matrix
    mat = torch.from_numpy(big).to(device)
    B, W = t.shape
    j = torch.arange(W + 1, device=device)[None, :]
    col_ok = j <= t_len[:, None]
    if local:
        h = torch.zeros(B, W + 1, dtype=torch.int64, device=device)
    else:
        h = torch.where(j == 0, 0, -(go + ge * j)).expand(B, W + 1).clone()
    f = torch.full((B, W + 1), NEG, dtype=torch.int64, device=device)
    best = torch.zeros(B, dtype=torch.int64, device=device)
    final = torch.full((B,), NEG, dtype=torch.int64, device=device)
    if not local:
        final = torch.where(q_len == 0, h.gather(1, t_len[:, None])[:, 0], final)
    ramp = ge * j
    for i in range(1, q.shape[1] + 1):
        sub = mat[q[:, i - 1][:, None], t]  # (B, W)
        f = torch.maximum(h - go - ge, f - ge)
        diag = h[:, :-1] + sub
        inner = torch.maximum(diag, f[:, 1:])
        first = torch.zeros(B, 1, dtype=torch.int64, device=device) if local else torch.full((B, 1), -(go + ge * i), dtype=torch.int64, device=device)
        h_no_e = torch.cat([first, inner], 1)
        if local:
            h_no_e = h_no_e.clamp_min(0)
        # E[j] = max_{k<j} (H'[k] - go - ge * (j - k)) = cummax_{k<j}(H'[k] + ge*k) - go - ge*j
        run = torch.cummax(h_no_e + ramp, 1).values
        e = torch.cat([torch.full((B, 1), NEG, dtype=torch.int64, device=device), run[:, :-1]], 1) - go - ramp
        h = torch.maximum(h_no_e, e)
        if local:
            live = col_ok & (i <= q_len)[:, None]
            best = torch.maximum(best, torch.where(live, h, 0).amax(1))
        else:
            final = torch.where(q_len == i, h.gather(1, t_len[:, None])[:, 0], final)
    return (best if local else final).cpu().numpy()


def gapless_optima(query: np.ndarray, target: np.ndarray, matrix: np.ndarray) -> tuple[int, set[float]]:
    r"""The best score of an ungapped local alignment of ``query`` and
    ``target``, and the identity (matches over aligned columns, in percent,
    as float32) of every ungapped segment that reaches it.

    The diagonals are laid out as columns (``k = j - i + len(query) - 1``),
    so prefix sums down a column are prefix sums along a diagonal; a
    segment ``(a, r]`` of a diagonal scores ``C[r] - C[a]``.
    """
    Lq, Lt = len(query), len(target)
    if Lq == 0 or Lt == 0:
        return 0, set()
    i = np.arange(Lq)[:, None]
    k = np.arange(Lt)[None, :] - i + (Lq - 1)
    rows = np.broadcast_to(i + 1, k.shape)
    score = np.zeros((Lq + 1, Lq + Lt - 1), dtype=np.int64)
    same = np.zeros_like(score)
    score[rows, k] = matrix[query[:, None].astype(np.int64), target[None, :].astype(np.int64)]
    same[rows, k] = query[:, None] == target[None, :]
    c = np.cumsum(score, axis=0)
    m = np.cumsum(same, axis=0)
    gain = c - np.minimum.accumulate(c, axis=0)  # row 0 and the zeros above a diagonal are its start
    valid = np.zeros(score.shape, dtype=bool)
    valid[rows, k] = True
    gain = np.where(valid, gain, -1)
    top = int(gain.max())
    idents: set[float] = set()
    if top <= 0:
        return top, idents
    for r, col in np.argwhere(gain == top):
        first = max(1, Lq - int(col))  # the diagonal's first cell's row
        a = np.arange(first - 1, r)
        for s in a[c[a, col] == c[r, col] - top]:
            n = int(r - s)
            idents.add(float(np.float32((m[r, col] - m[s, col]) * 100.0 / n)))
    return top, idents
