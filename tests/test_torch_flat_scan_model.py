"""A numpy model of the Hopper flat-scan kernel's algorithm (``csrc/scan.cu::minimizer_scan_kernel``),
held to the JAX package's ``minimizer_scan`` on the CPU.

A CUDA kernel cannot run here, so the word-level design the kernel runs is
written out in numpy, step for step, and held to the reference:

- a block scans a tile of ``TILE`` positions of one row; its words of 16
  positions start ``HALO`` = 32 positions before the tile (the windows that
  can select in it) and end three words after it (the last windows' reach
  and the last k-mers'). A word's codes are packed to 2 bits a base (``c &
  3``) plus a 16-bit mask of invalid codes (>= 4) and a flag for a code > 4;
  positions before 0 read the sentinel, positions at or past ``L`` read the
  code at ``g mod L`` (the rolls of the JAX scan), and a word that starts at
  or past ``L + 15`` is all sentinels (no output reads it);
- a position's k-mer is one funnel shift of two packed words: ``rev`` is its
  complement, ``fwd`` the bit reverse of the pair-swapped words' shift. The
  JAX scan packs the raw codes, so where a k-mer holds a sentinel its raw
  words are rebuilt for the strand: ``fwd | spread(mask) << 2`` and ``rev |
  0xFFFFFFFF << 2 j_min`` (``j_min`` the first invalid base); a word whose
  k-mers reach a code > 4 takes its strands from a loop over the raw codes;
- the window minimum is van Herk / Gil-Werman over a word's 16 + W - 1
  hashes (suffix minima with ``<=``, prefix minima with ``<``, the left part
  winning ties); each valid window marks its winner in the tile's mask
  (selection by scatter), and the mask is the output, with no AND of the
  k-mer's validity (a winner's hash is not 0xFFFFFFFF, so its k-mer is valid).

Panels: random, sentinel runs, an all-sentinel row, poly-A, codes 5 and 255,
valid bases up to the end, at L = 15, 25, 1023 and 4097; every w in 1..32 at
k = 15, and k in {1, 11, 16} at w in {1, 10, 32}; the model at the kernel's
tile (4096) and at a 64-position tile, whose blocks' halos cross inside
every panel.

Tolerance: exact on ``selected``, ``hashes`` and ``strands``.
"""

import numpy as np
import pytest

WORD = 16  # positions a thread owns
HALO = 32  # positions before the tile whose windows can select in it (>= w - 1)
TILE = 4096  # positions a block of the kernel
MAX_K = 16
U32 = np.uint32(0xFFFFFFFF)
LENGTHS = (15, 25, 1023, 4097)
KW = [(15, w) for w in range(1, 33)] + [(k, w) for k in (1, 11, 16) for w in (1, 10, 32)]


def _swap_pairs(x):
    return ((x >> np.uint32(1)) & np.uint32(0x55555555)) | ((x & np.uint32(0x55555555)) << np.uint32(1))


def _brev(x):
    """``__brev``: the 32 bits in reverse order."""
    x = ((x >> np.uint32(1)) & np.uint32(0x55555555)) | ((x & np.uint32(0x55555555)) << np.uint32(1))
    x = ((x >> np.uint32(2)) & np.uint32(0x33333333)) | ((x & np.uint32(0x33333333)) << np.uint32(2))
    x = ((x >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) | ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4))
    x = ((x >> np.uint32(8)) & np.uint32(0x00FF00FF)) | ((x & np.uint32(0x00FF00FF)) << np.uint32(8))
    return (x >> np.uint32(16)) | (x << np.uint32(16))


def _funnel(lo, hi, shift):
    """``__funnelshift_r(lo, hi, shift)``: the low 32 bits of ``hi:lo >> shift``."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((wide >> np.uint64(shift)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _spread_hi(m):
    """A 16-bit mask spread to the odd bits: bit i -> bit 2i + 1."""
    x = m.astype(np.uint32)
    x = (x | (x << np.uint32(8))) & np.uint32(0x00FF00FF)
    x = (x | (x << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    x = (x | (x << np.uint32(2))) & np.uint32(0x33333333)
    x = (x | (x << np.uint32(1))) & np.uint32(0x55555555)
    return x << np.uint32(1)


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _low_bits(n):
    return ((np.uint64(1) << n.astype(np.uint64)) - np.uint64(1)).astype(np.uint32)


def _below(end, g0):
    """How many of a word's 16 positions, which start at ``g0``, lie below ``end``."""
    return np.clip(end - g0, 0, WORD)


def flat_scan_model(codes: np.ndarray, k: int, w: int, tile: int = TILE):
    """The kernel's algorithm on one (L,) row: ``(selected, hashes uint32, strands)``."""
    L = len(codes)
    n_blocks = -(-L // tile)
    start_words = (HALO + tile) // WORD
    hash_words = start_words + 2
    code_words = hash_words + 1
    g0 = np.arange(n_blocks)[:, None] * tile - HALO + WORD * np.arange(code_words)[None, :]  # (blocks, words)

    # 1. Pack: codes read at g mod L past the row's end, the sentinel before 0 and in far words.
    g = g0[..., None] + np.arange(WORD)
    c = np.where(g < 0, 4, codes[np.mod(g, L)]).astype(np.uint32)
    c[g0 >= L + MAX_K - 1] = 4
    lanes = np.arange(WORD, dtype=np.uint32)
    word = np.bitwise_or.reduce((c & np.uint32(3)) << (np.uint32(2) * lanes), axis=-1)
    inv = np.bitwise_or.reduce((c >= 4).astype(np.uint32) << lanes, axis=-1)
    odd = (c > 4).any(-1)

    # 2. Hash and strand of each word's 16 k-mer starts, from two packed words by a funnel shift.
    w0, w1 = word[:, :hash_words], word[:, 1 : hash_words + 1]
    x0, x1 = _swap_pairs(w0), _swap_pairs(w1)
    ih0, ih1 = _spread_hi(inv[:, :hash_words]), _spread_hi(inv[:, 1 : hash_words + 1])
    inv32 = inv[:, :hash_words] | (inv[:, 1 : hash_words + 1] << np.uint32(16))
    bad, cover = inv32.copy(), 1
    while cover < k:  # bit j: an invalid base among the k that start at base j
        step = min(cover, k - cover)
        bad |= bad >> np.uint32(step)
        cover += step
    gw = g0[:, :hash_words]
    inside = _low_bits(_below(L - k + 1, gw)) & ~_low_bits(_below(0, gw))
    valid_bits = ~bad & inside
    kmask = U32 if k >= 16 else np.uint32((1 << (2 * k)) - 1)
    lowk = np.uint32((1 << k) - 1)
    fwd_shift = np.uint32(32 - 2 * k)
    hashes = np.empty((n_blocks, hash_words, WORD), np.uint32)
    strand_bits = np.zeros((n_blocks, hash_words), np.uint32)
    for j in range(WORD):
        rev = ~_funnel(w0, w1, 2 * j) & kmask
        fwd = _brev(_funnel(x0, x1, 2 * j)) >> fwd_shift
        valid = (valid_bits >> np.uint32(j)) & np.uint32(1)
        hashes[..., j] = np.where(valid == 1, _mix32(np.minimum(fwd, rev)), U32)
        # The raw words where the k-mer holds a sentinel (codes 0-4).
        m = (inv32 >> np.uint32(j)) & lowk
        j_min = np.zeros_like(m)
        for t in range(k - 1, -1, -1):  # the first set bit
            j_min = np.where((m >> np.uint32(t)) & np.uint32(1) == 1, np.uint32(t), j_min)
        rev_raw = np.where(m != 0, rev | (U32 << (np.uint32(2) * j_min)), rev)
        extra = (_brev(_funnel(ih0, ih1, 2 * j)) >> fwd_shift) << np.uint32(2)
        fwd_raw = np.where(m != 0, fwd | extra, fwd)
        strand_bits |= (fwd_raw <= rev_raw).astype(np.uint32) << np.uint32(j)
    # A word whose k-mers reach a code > 4: its strands from the raw codes.
    for b, t in zip(*np.nonzero(odd[:, :hash_words] | odd[:, 1 : hash_words + 1])):
        raw = [int(x) for x in np.concatenate([c[b, t], c[b, t + 1]])]
        bits = 0
        for j in range(WORD):
            f = r = 0
            for i in range(k):
                f |= raw[j + i] << 2 * (k - 1 - i)
                r |= ((3 - raw[j + i]) & 0xFFFFFFFF) << 2 * i
            bits |= int((f & 0xFFFFFFFF) <= (r & 0xFFFFFFFF)) << j
        strand_bits[b, t] = bits

    # 3. Van Herk / Gil-Werman windows; each valid window marks its winner (selection by scatter).
    run = hashes.reshape(n_blocks, -1)
    span = WORD + w - 1
    idx = WORD * np.arange(start_words)[:, None] + np.arange(span)[None, :]
    h = run[:, idx]  # (blocks, start words, 16 + w - 1): a word's run of hashes
    gs = g0[:, :start_words]
    starts = _low_bits(_below(L - k - w + 2, gs)) & ~_low_bits(_below(0, gs))
    last = (WORD - 1) // w * w + w - 1
    cur_h = np.zeros(h.shape[:2], np.uint32)
    cur_p = np.zeros(h.shape[:2], np.int64)
    suffix_h = np.zeros((*h.shape[:2], WORD), np.uint32)
    suffix_p = np.zeros((*h.shape[:2], WORD), np.int64)
    for i in range(last, -1, -1):  # suffix minima inside blocks of w: <=, the leftmost wins
        x = h[..., i]
        take = (i % w == w - 1) | (x <= cur_h)
        cur_h, cur_p = np.where(take, x, cur_h), np.where(take, i, cur_p)
        if i < WORD:
            suffix_h[..., i], suffix_p[..., i] = cur_h, cur_p
    marks = np.zeros((n_blocks, hash_words * WORD), bool)
    for i in range(span):  # prefix minima: strict <
        x = h[..., i]
        take = (i % w == 0) | (x < cur_h)
        cur_h, cur_p = np.where(take, x, cur_h), np.where(take, i, cur_p)
        if i >= w - 1:
            j = i - (w - 1)
            right = cur_h < suffix_h[..., j]
            best = np.where(right, cur_h, suffix_h[..., j])
            win = np.where(right, cur_p, suffix_p[..., j])
            ok = (best != U32) & ((starts >> np.uint32(j)) & np.uint32(1) == 1)
            blk, t = np.nonzero(ok)
            marks[blk, WORD * t + win[blk, t]] = True

    # 4. The tile's positions inside the row.
    q = np.arange(L)
    blk, x = q // tile, HALO + q % tile
    strands = (strand_bits[blk, x // WORD] >> (x % WORD).astype(np.uint32)) & np.uint32(1)
    return marks[blk, x], run[blk, x], strands == 1


def _panel(name: str, L: int, rng) -> np.ndarray:
    codes = rng.integers(0, 4, L).astype(np.uint8)
    if name == "random":
        codes[rng.random(L) < 0.01] = 4
    elif name == "sentinel-runs":
        for s in rng.integers(0, L, 3):
            codes[s : s + rng.integers(1, 40)] = 4
        codes[-2:] = 4
        # At k = 16 the forward rebuild's bit decides the strand where a k-mer starts here.
        codes[L // 3 : L // 3 + 10] = (3, 3, 3, 3, 3, 3, 3, 2, 4, 4)[: L - L // 3]
    elif name == "all-sentinel":
        codes[:] = 4
    elif name == "poly-a":
        codes[L // 4 : L // 4 + max(L // 2, 1)] = 0
    elif name == "codes-5-255":
        codes[rng.random(L) < 0.02] = 5
        codes[rng.random(L) < 0.02] = 255
        codes[rng.random(L) < 0.02] = 4
        codes[-1] = 255  # read by the k-mers that roll over the end
    elif name == "valid-to-end":
        pass  # valid bases everywhere: the last k - 1 k-mers roll over to the row's start
    return codes


PANEL_NAMES = ("random", "sentinel-runs", "all-sentinel", "poly-a", "codes-5-255", "valid-to-end")


@pytest.mark.parametrize("kw", KW, ids=[f"k{k}-w{w}" for k, w in KW])
def test_flat_scan_model_equals_jax(kw):
    from kaptive_tpu.ops.minimizer import minimizer_scan

    k, w = kw
    for L in LENGTHS:
        rng = np.random.default_rng(1000 * L + 37 * k + w)
        for name in PANEL_NAMES:
            codes = _panel(name, L, rng)
            want = [np.asarray(x) for x in minimizer_scan(codes, k, w)]
            for tile in (TILE, 64):
                got = flat_scan_model(codes, k, w, tile)
                for field, g, x in zip(("selected", "hashes", "strands"), got, want):
                    np.testing.assert_array_equal(g, x, err_msg=f"{field} {name} L={L} tile={tile}")


def test_raw_rebuild_equals_raw_packing():
    """For codes 0-4, the rebuilt raw words equal the JAX packing of the raw codes at every k
    and every sentinel pattern of a k-mer (the premise of the strands at invalid positions)."""
    rng = np.random.default_rng(3)
    for k in range(1, MAX_K + 1):
        kmask = U32 if k >= 16 else np.uint32((1 << (2 * k)) - 1)
        raw = rng.integers(0, 4, (4096, k)).astype(np.uint32)
        raw[rng.random((4096, k)) < 0.3] = 4
        raw[:k] = 4  # all sentinels
        shifts_f = np.uint32(2) * (k - 1 - np.arange(k, dtype=np.uint32))
        shifts_r = np.uint32(2) * np.arange(k, dtype=np.uint32)
        fwd_want = np.bitwise_or.reduce(raw << shifts_f, axis=1)
        rev_want = np.bitwise_or.reduce((np.uint32(3) - raw) << shifts_r, axis=1)
        packed = np.bitwise_or.reduce((raw & np.uint32(3)) << shifts_r, axis=1)
        mask = np.bitwise_or.reduce((raw >= 4).astype(np.uint32) << np.arange(k, dtype=np.uint32), axis=1)
        zero = np.zeros_like(packed)
        rev = ~packed & kmask
        fwd = _brev(_funnel(_swap_pairs(packed), zero, 0)) >> np.uint32(32 - 2 * k)
        j_min = np.array([(int(m) & -int(m)).bit_length() - 1 for m in mask])
        rev_raw = np.where(mask != 0, rev | (U32 << (np.uint32(2) * np.maximum(j_min, 0).astype(np.uint32))), rev)
        extra = (_brev(_spread_hi(mask)) >> np.uint32(32 - 2 * k)) << np.uint32(2)
        np.testing.assert_array_equal(rev_raw, rev_want, err_msg=f"rev k={k}")
        np.testing.assert_array_equal(fwd | extra, fwd_want, err_msg=f"fwd k={k}")
