"""A numpy model of the scans' run-time form (``csrc/scan.cu::scan_rt_kernel``), held to the JAX
package on the CPU.

A CUDA kernel cannot run here, so the design the kernel runs for any ``k`` and
``w`` is written out in numpy, step for step, and held to the reference:

- a block scans a tile of ``tile`` positions of one stream; its run starts
  ``hb`` = ``w - 1`` positions before the tile, rounded up to 32, hashes ``hb
  + tile + w - 1`` positions (``nhw`` words of 16) and packs ``k + 31`` more
  codes (``scan_panels.any_plan``, the kernel's ``rt_plan``).  A word is
  packed to 2 bits a base (``c & 3``) with a 16-bit invalid mask and a flag
  for a code > 4; the flat form reads the sentinel before 0 and the code at
  ``g mod L`` past ``L`` (a word from ``L + k - 1`` on is all sentinels), the
  row-compact form its sentinel-padded stream (a word outside it is all
  sentinels);
- a position's reverse field is the ``kk = min(k, 16)`` bases that start
  there, its forward field the ``kk`` bases that end at its k-mer's last: each
  one funnel shift of two packed words (the forward pair funnel-shifted by
  ``(k - kk) mod 16`` bases first): the JAX package's uint32 packings, whose
  shifts of 32 or more drop a base.  Validity: no invalid bit among the k
  mask bits, from a 48-bit window of masks for ``k <= 32`` and from an
  exclusive prefix count of invalid bases (a block scan) past that.  The flat
  form rebuilds the raw packings' strands where a k-mer holds a sentinel, and
  takes a word's strands from its raw codes where its k-mers reach a code > 4;
- the windows: van Herk / Gil-Werman in blocks of ``w`` over the run of
  (hash, position) pairs; a forward segmented scan stores each position's
  prefix minimum in its block (a minimum moves only when strictly smaller), a
  backward one gives each window start its suffix minimum (it moves on a tie
  too: the leftmost wins), joined with the prefix minimum at the window's end
  (taken only when strictly smaller); each scan is a
  word's 16 positions, then the kernel's block scan itself: rounds of 288
  words, a Hillis-Steele scan in each warp of 32 (lanes below the shift keep
  their value), the 9 warps' totals scanned the same way, a carry from round
  to round.  A
  window whose minimum is not 0xFFFFFFFF and that starts inside ``[0,
  length-k-w+2)`` marks its winner in the tile's mask (selection by scatter);
- output: the flat form's tile positions, the row-compact form's rows ranked
  into 64 slots with the full count.

Held to ``minimizer_scan_host`` (the numpy mirror of ``minimizer_scan``: the
jitted scan unrolls ``w`` window steps; it is held at k in {17, 33} and w = 7
below) and to ``rowcompact_scan_xla``
for k in {1, 16, 17, 20, 31, 32, 33, 40} and w in {1, 33, 40, 1100} and the
widest w the form takes at that k, at the kernel's smallest tile (4,096), a
wider one (8,192) and a 256-position tile whose halos cross inside every
panel.  Panels: sentinels and codes 5 / 255 laid across tile edges, poly-A
across them, valid bases to the end (k-mers that roll over it), an
all-sentinel row, and streams shorter than a k-mer (F10).

Tolerance: exact on every output.
"""

import numpy as np
import pytest
from scan_panels import ANY_THREADS, any_max_w, any_plan

from kaptive_tpu.ops import minimizer as jax_minimizer
from kaptive_tpu.ops import scan_pallas as jax_scan

WORD = 16
WARP = 32
U32 = np.uint32(0xFFFFFFFF)
ROW, SLOTS, HALO_ROWS = 128, 64, 8


def _swap_pairs(x):
    return ((x >> np.uint32(1)) & np.uint32(0x55555555)) | ((x & np.uint32(0x55555555)) << np.uint32(1))


def _brev(x):
    """``__brev``: the 32 bits in reverse order."""
    x = _swap_pairs(x)
    x = ((x >> np.uint32(2)) & np.uint32(0x33333333)) | ((x & np.uint32(0x33333333)) << np.uint32(2))
    x = ((x >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) | ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4))
    x = ((x >> np.uint32(8)) & np.uint32(0x00FF00FF)) | ((x & np.uint32(0x00FF00FF)) << np.uint32(8))
    return (x >> np.uint32(16)) | (x << np.uint32(16))


def _funnel(lo, hi, shift):
    """``__funnelshift_r(lo, hi, shift)`` for shift in [0, 31]: the low 32 bits of ``hi:lo >> shift``."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (wide >> np.uint64(shift)).astype(np.uint32)


def _spread_hi(m):
    """A 16-bit mask spread to the odd bits: bit i -> bit 2i + 1."""
    x = m.astype(np.uint32) & np.uint32(0xFFFF)
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
    """``low_bits``: the low n bits set, n in [0, 32]."""
    return ((np.uint64(1) << np.asarray(n, np.uint64)) - np.uint64(1)).astype(np.uint32)


def _below(end, g0):
    """How many of a word's 16 positions, which start at ``g0``, lie below ``end``."""
    return np.clip(end - g0, 0, WORD)


def _popc(x):
    return np.unpackbits(np.asarray(x, np.uint32)[..., None].view(np.uint8), axis=-1).sum(-1).astype(np.int64)


# ------------------------------------------------------------------------------------- the block scan


def _seg_join(backward: bool):
    """``seg_join<BACKWARD>``, a before b in scan order: ``(leftmost minimum hash since the last
    restart, its position, restart seen)``; b's minimum wins when strictly smaller (forward) or
    also on a tie (backward: b lies left)."""

    def join(a, b):
        (ah, ap, af), (bh, bp, bf) = a, b
        take = bf | ((bh <= ah) if backward else (bh < ah))
        return np.where(take, bh, ah), np.where(take, bp, ap), af | bf

    return join


def _sum_join(a, b):
    return (a[0] + b[0],)


def _inclusive(t, lanes, join, identity):
    """``warp_inclusive`` over the last axis: Hillis-Steele steps below ``lanes``, a lane below the
    shift keeping its value (shifting in the identity does the same: it is a left identity)."""
    d = 1
    while d < lanes:
        shifted = tuple(np.concatenate([np.full((*a.shape[:-1], d), i, a.dtype), a[..., :-d]], -1)
                        for a, i in zip(t, identity))
        t = join(shifted, t)
        d <<= 1
    return t


def block_exclusive(vals, join, identity):
    """``block_exclusive`` over words in scan order (last axis): rounds of 288 threads; each warp
    of 32 scans its lanes, then the 9 warps' totals are scanned the same way (in 16 lanes) and
    warp q's lanes start from the totals before q; a carry passes from round to round.
    ``vals`` and ``identity`` are tuples of arrays / scalars; returns the exclusive prefixes."""
    n = vals[0].shape[-1]
    lead = vals[0].shape[:-1]
    rounds = -(-n // ANY_THREADS)
    pad = rounds * ANY_THREADS - n
    vals = [np.concatenate([v, np.full((*lead, pad), i, v.dtype)], -1) for v, i in zip(vals, identity)]
    carry = tuple(np.full(lead, i, v.dtype) for v, i in zip(vals, identity))
    out = [np.empty_like(v) for v in vals]
    warps = ANY_THREADS // WARP
    for r in range(rounds):
        x = tuple(v[..., r * ANY_THREADS:(r + 1) * ANY_THREADS].reshape(*lead, warps, WARP) for v in vals)
        incl = _inclusive(x, WARP, join, identity)
        up = tuple(np.concatenate([np.full((*lead, warps, 1), i, a.dtype), a[..., :-1]], -1)
                   for a, i in zip(incl, identity))  # __shfl_up_sync by 1
        totals = tuple(np.concatenate([a[..., WARP - 1], np.full((*lead, 16 - warps), i, a.dtype)], -1)
                       for a, i in zip(incl, identity))
        totals = _inclusive(totals, 16, join, identity)
        for q in range(warps):
            before = join(carry, tuple(t[..., q - 1] for t in totals)) if q else carry
            lane_excl = join(tuple(b[..., None] for b in before), tuple(u[..., q, :] for u in up))
            for o, e in zip(out, lane_excl):
                o[..., r * ANY_THREADS + q * WARP:r * ANY_THREADS + (q + 1) * WARP] = e
        carry = join(carry, tuple(t[..., warps - 1] for t in totals))
    return tuple(o[..., :n] for o in out)


# ------------------------------------------------------------------------------------------ the model


def scan_rt_model(rows: np.ndarray, k: int, w: int, tile: int, flat: bool):
    """``scan_rt_kernel`` on (B, n) code rows.  Flat: each row is a stream of L = n positions;
    returns ``(selected, hashes uint32, strands)`` of (B, L).  Row-compact: each row is a
    sentinel-padded (R + 16) * 128 stream; returns ``(hashes, aux, counts)`` as int32 arrays."""
    plan = any_plan(k, w, tile)
    assert plan is not None, (k, w, tile)
    hb, nhw, ncw = plan["hb"], plan["nhw"], plan["ncw"]
    B, n = rows.shape
    pad = 0 if flat else HALO_ROWS * ROW
    length = n if flat else n - 2 * pad
    n_tiles = -(-length // tile)
    r0 = tile * np.arange(n_tiles, dtype=np.int64) - hb  # stream position of each block's run position 0
    g0 = r0[:, None] + WORD * np.arange(ncw, dtype=np.int64)[None, :]  # (tiles, ncw): each code word's first

    # 1. Pack.
    g = g0[..., None] + np.arange(WORD)  # (tiles, ncw, 16)
    if flat:
        c = np.where(g < 0, 4, rows[:, np.mod(g, n)]).astype(np.uint32)  # code_at
        c[:, ~((g0 + WORD > 0) & (g0 < length + k - 1))] = 4
    else:
        p = pad + g0
        c = rows[:, np.clip(pad + g, 0, n - 1)].astype(np.uint32)
        c[:, ~((p >= 0) & (p + WORD <= n))] = 4
    lanes = np.arange(WORD, dtype=np.uint32)
    word = np.bitwise_or.reduce((c & np.uint32(3)) << (np.uint32(2) * lanes), axis=-1)  # (B, tiles, ncw)
    inv = np.bitwise_or.reduce((c >= 4).astype(np.uint32) << lanes, axis=-1)
    odd = (c > 4).any(-1)
    if k > 32:
        (cnt,) = block_exclusive((_popc(inv),), _sum_join, (0,))

    # 2. Hash, validity and strands of each hashed word's 16 k-mer starts.
    kk = min(k, WORD)
    fo = k - kk
    wd = np.arange(nhw)
    gw = g0[:, :nhw]
    if k <= 32:
        inv64 = inv[..., wd].astype(np.uint64) | (inv[..., wd + 1].astype(np.uint64) << np.uint64(16)) | (
            inv[..., wd + 2].astype(np.uint64) << np.uint64(32))
        bad, cover = inv64.copy(), 1
        while cover < k:
            step = min(cover, k - cover)
            bad |= bad >> np.uint64(step)
            cover += step
        bad = (bad & np.uint64(0xFFFF)).astype(np.uint32)
    else:
        def before(x):  # invalid bases among run positions [0, x)
            return np.take(cnt, x >> 4, -1) + _popc(np.take(inv, x >> 4, -1) & _low_bits(x & 15))

        bad = np.zeros(inv[..., :nhw].shape, np.uint32)
        for j in range(WORD):
            x = WORD * wd + j
            bad |= (before(x + k) != before(x)).astype(np.uint32) << np.uint32(j)
    inside = _low_bits(_below(length - k + 1, gw)) & ~_low_bits(_below(0, gw))
    valid_bits = ~bad & inside & np.uint32(0xFFFF)
    w0, w1 = word[..., wd], word[..., wd + 1]
    a, sh = wd + (fo >> 4), 2 * (fo & 15)
    f0, f1 = _funnel(word[..., a], word[..., a + 1], sh), _funnel(word[..., a + 1], word[..., a + 2], sh)
    inv_r = inv[..., wd] | (inv[..., wd + 1] << np.uint32(16))
    inv_f = ((inv[..., a].astype(np.uint64) | (inv[..., a + 1].astype(np.uint64) << np.uint64(16))
              | (inv[..., a + 2].astype(np.uint64) << np.uint64(32))) >> np.uint64(fo & 15)).astype(np.uint32)
    stored = (wd >= hb // WORD) & (wd < (hb + tile) // WORD)
    rebuild = flat & stored & (((inv_r | inv_f) & _low_bits(WORD + kk - 1)) != 0)
    x0, x1 = _swap_pairs(f0), _swap_pairs(f1)
    ih0, ih1 = _spread_hi(inv_f), _spread_hi(inv_f >> np.uint32(16))
    kmask = U32 if kk >= 16 else np.uint32((1 << (2 * kk)) - 1)
    fwd_shift = np.uint32(32 - 2 * kk)
    lowk = _low_bits(kk)
    hashes = np.empty((*w0.shape, WORD), np.uint32)
    strand_bits = np.zeros(w0.shape, np.uint32)
    for j in range(WORD):
        rev = ~_funnel(w0, w1, 2 * j) & kmask
        fwd = _brev(_funnel(x0, x1, 2 * j)) >> fwd_shift
        hashes[..., j] = np.where((valid_bits >> np.uint32(j)) & np.uint32(1) == 1, _mix32(np.minimum(fwd, rev)), U32)
        mr = (inv_r >> np.uint32(j)) & lowk
        first = np.zeros_like(mr)  # __ffs(mr) - 1
        for t in range(kk - 1, -1, -1):
            first = np.where((mr >> np.uint32(t)) & np.uint32(1) == 1, np.uint32(t), first)
        rev = np.where(rebuild & (mr != 0), rev | (U32 << (np.uint32(2) * first)), rev)
        extra = (_brev(_funnel(ih0, ih1, 2 * j)) >> fwd_shift) << np.uint32(2)
        fwd = np.where(rebuild & (((inv_f >> np.uint32(j)) & lowk) != 0), fwd | extra, fwd)
        strand_bits |= (fwd <= rev).astype(np.uint32) << np.uint32(j)
    # A word whose k-mers reach a code > 4 (and a sentinel-rebuilt one): its strands from the raw codes.
    for b, t, q in zip(*np.nonzero(rebuild)):
        if not odd[b, t, q:((WORD * q + WORD - 2 + k) >> 4) + 1].any():
            continue
        row, gq = rows[b], int(g0[t, q])
        code_at = [4 if x < 0 else int(row[x % n]) for x in range(gq, gq + WORD + k)]
        bits = 0
        for j in range(WORD):
            f = r = 0
            for i in range(kk):
                r |= ((3 - code_at[j + i]) & 0xFFFFFFFF) << 2 * i
                f |= code_at[j + k - kk + i] << 2 * (kk - 1 - i)
            bits |= int((f & 0xFFFFFFFF) <= (r & 0xFFFFFFFF)) << j
        strand_bits[b, t, q] = bits

    # 3. Windows: prefix minima forward, suffix minima backward, (hash, position) with ties left.
    nx = WORD * nhw
    hw = hashes.reshape(*hashes.shape[:2], nhw, WORD)
    xw = np.broadcast_to(WORD * wd[:, None] + np.arange(WORD)[None, :], hw.shape).astype(np.int64)
    pos = (WORD * wd[:, None] + np.arange(WORD)[None, :]) % w  # (nhw, 16): a position's place in its block
    ident = (U32, 0, False)

    def passes(order, restart, backward):
        """A word's own pass, the block scan, then its pass from the scan's prefix: the minimum
        (hash, position) at each of its positions."""
        h = np.full(hw.shape[:3], U32, np.uint32)
        p = np.zeros(hw.shape[:3], np.int64)
        f = np.zeros(hw.shape[:3], bool)
        for j in order:
            r = restart[:, j]
            take = r | ((hw[..., j] <= h) if backward else (hw[..., j] < h))
            h, p, f = np.where(take, hw[..., j], h), np.where(take, xw[..., j], p), f | r
        flip = (lambda a: a[..., ::-1]) if backward else (lambda a: a)  # thread tid takes word nhw-1-tid
        cur_h, cur_p, _ = (flip(a) for a in block_exclusive((flip(h), flip(p), flip(f)), _seg_join(backward), ident))
        out_h, out_p = np.empty_like(hw), np.empty_like(xw)
        for j in order:
            take = restart[:, j] | ((hw[..., j] <= cur_h) if backward else (hw[..., j] < cur_h))
            cur_h, cur_p = np.where(take, hw[..., j], cur_h), np.where(take, xw[..., j], cur_p)
            out_h[..., j], out_p[..., j] = cur_h, cur_p
        return out_h.reshape(*hw.shape[:2], nx), out_p.reshape(*hw.shape[:2], nx)

    pre_h, pre_p = passes(range(WORD), pos == 0, False)
    pre_p &= 0xFFFF  # a 16-bit shared array
    suf_h, suf_p = passes(range(WORD - 1, -1, -1), pos == w - 1, True)
    n_st = hb + tile
    gs = r0[:, None] + np.arange(n_st)
    starts = (gs >= 0) & (gs < length - k - w + 2)
    right = pre_h[..., w - 1:w - 1 + n_st] < suf_h[..., :n_st]  # the suffix part lies left: it wins a tie
    best = np.where(right, pre_h[..., w - 1:w - 1 + n_st], suf_h[..., :n_st])
    win = np.where(right, pre_p[..., w - 1:w - 1 + n_st], suf_p[..., :n_st]) - hb
    ok = starts & (best != U32) & (win >= 0) & (win < tile)
    sel = np.zeros((B, n_tiles, tile), bool)
    bb, tt, ss = np.nonzero(ok)
    sel[bb, tt, win[bb, tt, ss]] = True  # selection by scatter

    # 4. Output.
    run_hash = hashes.reshape(*hashes.shape[:2], nx)[..., hb:hb + tile]
    run_strand = ((strand_bits[..., hb // WORD:(hb + tile) // WORD, None] >> lanes) & np.uint32(1)).reshape(
        B, n_tiles, tile) == 1
    if flat:
        return tuple(x.reshape(B, -1)[:, :length] for x in (sel, run_hash, run_strand))
    R = length // ROW
    sel_r = sel.reshape(B, -1, ROW)[:, :R]
    h_r = run_hash.reshape(B, -1, ROW)[:, :R].view(np.int32)
    a_r = (np.arange(ROW) | (run_strand.reshape(B, -1, ROW)[:, :R].astype(np.int32) << 7)).astype(np.int32)
    out_h = np.full((B, R, SLOTS), -1, np.int32)
    out_a = np.full((B, R, SLOTS), -1, np.int32)
    rank = np.cumsum(sel_r, -1) - 1
    b_i, r_i, c_i = np.nonzero(sel_r & (rank < SLOTS))
    out_h[b_i, r_i, rank[b_i, r_i, c_i]] = h_r[b_i, r_i, c_i]
    out_a[b_i, r_i, rank[b_i, r_i, c_i]] = a_r[b_i, r_i, c_i]
    return out_h, out_a, sel_r.sum(-1, dtype=np.int32)[..., None]


# ---------------------------------------------------------------------------------------------- panels


EDGES = (256, 4096, 8192)  # tile edges at every tile the model runs at


def _edge_panel(rng, L: int) -> np.ndarray:
    """Random bases with sentinels, codes 5 and 255, a poly-A run and a period-2 repeat laid
    across the tile edges; valid bases up to the end (k-mers that roll over it)."""
    codes = rng.integers(0, 4, L).astype(np.uint8)
    codes[rng.random(L) < 0.004] = 4
    for e in range(256, L - 300, 256):
        kind = (e // 256) % 5
        if kind == 0:
            codes[e - 1:e + 1] = 4
        elif kind == 1:
            codes[e - 2], codes[e + 1] = 5, 255
        elif kind == 2:
            codes[e - 150:e + 150] = 0
        elif kind == 3:
            codes[e - 40:e + 40] = np.resize(np.array([1, 2], np.uint8), 80)
    for e in EDGES:
        if e < L:
            codes[e - 3:e + 3] = (3, 3, 4, 2, 5, 1)
    codes[-3:] = (1, 2, 3)
    return codes


def flat_rows(L: int, seed: int) -> np.ndarray:
    """(3, L): an edge panel, a poly-A panel with sentinels, and an all-sentinel row."""
    rng = np.random.default_rng(seed)
    a = _edge_panel(rng, L)
    b = rng.integers(0, 4, L).astype(np.uint8)
    b[L // 5:L // 5 + L // 2] = 0
    b[rng.random(L) < 0.01] = 4
    b[-1] = 255
    return np.stack([a, b, np.full(L, 4, np.uint8)])


def rowcompact_rows(R: int, seed: int) -> np.ndarray:
    """(3, (R + 16) * 128): the flat panels' rows, sentinel-padded (codes 5 and 255 stay: the
    row-compact scans read only whether a code is below 4 where they select)."""
    streams = flat_rows(R * ROW, seed)
    halo = np.full((3, HALO_ROWS * ROW), 4, np.uint8)
    return np.concatenate([halo, streams, halo], 1)


def _assert_flat(L, seed, k, w, tiles):
    rows = flat_rows(L, seed)
    want = [np.stack(x) for x in zip(*(jax_minimizer.minimizer_scan_host(r, k, w) for r in rows))]
    for tile in tiles:
        got = scan_rt_model(rows, k, w, tile, flat=True)
        for name, g, x in zip(("selected", "hashes", "strands"), got, want):
            np.testing.assert_array_equal(g, x, err_msg=f"{name} L={L} k={k} w={w} tile={tile}")
    return want


def _assert_rowcompact(R, seed, k, w, tiles):
    rows = rowcompact_rows(R, seed)
    want = [np.asarray(x).view(np.int32) for x in jax_scan.rowcompact_scan_xla(rows.reshape(3, -1, ROW), k, w)]
    for tile in tiles:
        got = scan_rt_model(rows, k, w, tile, flat=False)
        for name, g, x in zip(("hashes", "aux", "counts"), got, want):
            np.testing.assert_array_equal(g, x, err_msg=f"{name} R={R} k={k} w={w} tile={tile}")
    return want


KS = (1, 16, 17, 20, 31, 32, 33, 40)
WS = (1, 33, 40, 1100)
KW = [(k, w) for k in KS for w in WS]


@pytest.mark.parametrize("kw", KW, ids=[f"k{k}-w{w}" for k, w in KW])
def test_scan_rt_model_equals_jax(kw):
    """Both forms of the model at 256, 4,096 and 8,192 positions a tile, on 9,001-position flat
    rows and 72-row genomes."""
    k, w = kw
    want = _assert_flat(9001, 7 * k + w, k, w, (256, 4096, 8192))
    assert want[0][0].any() and not want[0][2].any()
    counts = _assert_rowcompact(72, 5 * k + w, k, w, (256, 4096, 8192))[2]
    assert counts[0].sum() > 0 and counts[2].sum() == 0


@pytest.mark.parametrize("k", KS)
def test_scan_rt_model_at_the_widest_window(k):
    """The widest w the form takes at k (``kts_scan_any_max_w``): one window past a tile's run
    on each side, at the kernel's tile and at 256."""
    w = any_max_w(k)
    assert w >= 1100 and any_plan(k, w + 1) is None
    want = _assert_flat(w + k + 700, k, k, w, (256, 4096))
    assert want[0][0].any()
    R = -(-(w + k + 700) // ROW)
    assert _assert_rowcompact(R, k + 1, k, w, (256, 4096))[2][0].sum() > 0


@pytest.mark.parametrize("kw", [(17, 1), (20, 5), (33, 3), (40, 10), (31, 40), (16, 33)], ids=str)
def test_scan_rt_model_on_streams_shorter_than_a_kmer(kw):
    """F10: streams of 1 to 45 positions, many shorter than k: no k-mer is valid, and every
    position's strand comes from k-mers that wrap at L, more than once where k > L."""
    k, w = kw
    for L in (1, 7, 20, 25, 45):
        rng = np.random.default_rng(L * k)
        rows = rng.integers(0, 4, (3, L)).astype(np.uint8)
        rows[1, rng.random(L) < 0.2] = 4
        rows[2, -1] = 5
        want = [np.stack(x) for x in zip(*(jax_minimizer.minimizer_scan_host(r, k, w) for r in rows))]
        got = scan_rt_model(rows, k, w, 256, flat=True)
        for name, g, x in zip(("selected", "hashes", "strands"), got, want):
            np.testing.assert_array_equal(g, x, err_msg=f"{name} L={L}")


@pytest.mark.parametrize("k", [17, 33])
def test_scan_rt_model_equals_jitted_scan(k):
    rows = flat_rows(3000, k)
    for r in range(3):
        want = [np.asarray(x) for x in jax_minimizer.minimizer_scan(rows[r], k, 7)]
        got = scan_rt_model(rows[r:r + 1], k, 7, 256, flat=True)
        for name, g, x in zip(("selected", "hashes", "strands"), got, want):
            np.testing.assert_array_equal(g[0], x, err_msg=f"{name} row {r}")


def test_block_exclusive_equals_a_sequential_scan():
    """The kernel's round / warp / lane order gives each word the sequential exclusive prefix,
    for the segmented minimum in both directions at any restart pattern and over many rounds
    (hashes from a small range, so ties are common), and for the sum."""
    rng = np.random.default_rng(11)
    n = 3 * ANY_THREADS + 17
    h = rng.integers(0, 50, (4, n)).astype(np.uint32)
    p = np.broadcast_to(np.arange(n), (4, n)).copy()
    f = rng.random((4, n)) < np.array([0.0, 0.01, 0.3, 1.0])[:, None]
    for backward in (False, True):
        join = _seg_join(backward)
        got = block_exclusive((h, p, f), join, (U32, 0, False))
        cur = (np.full(4, U32, np.uint32), np.zeros(4, np.int64), np.zeros(4, bool))
        for i in range(n):
            for g, c in zip(got, cur):
                np.testing.assert_array_equal(g[:, i], c)
            cur = join(cur, (h[:, i], p[:, i], f[:, i]))
    c = rng.integers(0, 17, (2, n))
    (got,) = block_exclusive((c,), _sum_join, (0,))
    np.testing.assert_array_equal(got, np.cumsum(c, -1) - c)
