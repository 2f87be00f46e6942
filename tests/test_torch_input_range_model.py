"""Numpy models of the kernel forms that widened the card's input range, held to the JAX
package on the CPU.

A CUDA kernel cannot run here, so the algorithm each new form runs is written
out in numpy, step for step, and held to the reference:

- ``csrc/swg.cu::swg_fill_segmented_kernel``, the fill's segmented form: one
  pair's band walked a row at a time in segments of ``seg`` lanes, each
  segment filled from the row above at its own lanes and at the lane after
  its last (which the next segment has not written yet) and written back
  before the next (the kernel stages it in shared memory: the same as an
  update in place), the left neighbour of its first lane taken from the
  segment before, the exclusive max-plus scan's carry passed from segment to
  segment (-INF at a row's lane 0), and the row's best kept across segments
  by a strictly-greater update; int32 scores.  Held to
  the JAX package's ``_fill_band`` (traceback bits on the rows the query
  reaches, best score, row and column) at segments of 8,192 lanes (the
  kernel's) and of 64 and 48 lanes, so that every band crosses several.
- ``csrc/scan.cu``'s sparse-table form of both scans (the form past the
  run-time form's widest window; that form's own model is
  ``tests/test_torch_scan_any_tiled_model.py``): a position's k codes
  packed as the JAX package's uint32 shifts pack them (a term whose shift is
  32 or more dropped, every shift guarded), validity over all k codes, a
  sparse table of ``hash << 32 | position`` keys (``floor(log2 w)`` passes of
  ``min(key[g], key[g + 2^j])``), a window as the minimum of its two
  overlapping spans, winners marked by scatter, and (row-compact) each row's
  selected positions ranked into 64 slots.  Held to ``minimizer_scan`` (and
  its numpy mirror ``minimizer_scan_host`` where the jitted scan would unroll
  hundreds of window steps) and to ``rowcompact_scan_xla``.

Tolerance: exact.
"""

import functools

import jax
import numpy as np
import pytest
from range_panels import F7_W_PAD, f7_bucket, flat_panel, rowcompact_panel, scaled_blosum
from swg_panels import AA, NT, blosum_matrix, nt_matrix, random_swg_batch

from kaptive_tpu.ops import minimizer as jax_minimizer
from kaptive_tpu.ops import scan_pallas as jax_scan
from kaptive_tpu.ops import swg as jax_swg

NEG_INF = -1_000_000_000
INT32_MIN = np.iinfo(np.int32).min
U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------------- the segmented fill


def segmented_fill_model(q, q_lens, t, t_lens, offsets, k_locals, matrix, go, ge, rows_max, w_pad, seg):
    """``swg_fill_segmented_kernel``: ``(tb, best, best_i, best_j)``, rows past a query left at 0."""
    i32 = np.int32
    B, T = q.shape[0], t.shape[1]
    k_pad = (w_pad - 3) // 2
    goe = go + ge
    tb = np.zeros((B, rows_max, w_pad), np.uint8)
    out = np.zeros((3, B), np.int64)
    dm_all = np.arange(w_pad, dtype=np.int64)
    for b in range(B):
        cols, off, kl = int(t_lens[b]) + 1, int(offsets[b]), int(k_locals[b])
        j0 = dm_all - off - k_pad - 1
        M = np.where((np.abs(dm_all - (k_pad + 1)) <= kl + 1) & (j0 >= 0) & (j0 < cols), 0, NEG_INF).astype(i32)
        D = np.full(w_pad, NEG_INF, i32)
        I = np.full(w_pad, NEG_INF, i32)
        best = best_i = best_j = 0
        for i in range(1, min(int(q_lens[b]), rows_max) + 1):
            mrow = matrix[int(q[b, i - 1])].astype(i32)
            j_base = i - off - k_pad - 1
            t_base = i - off + w_pad - k_pad
            carry = NEG_INF
            seg_best, seg_lane = INT32_MIN, w_pad
            for s0 in range(0, w_pad, seg):
                dm = np.arange(s0, min(s0 + seg, w_pad))
                j = j_base + dm
                band = np.abs(dm - (k_pad + 1))
                in_cols = (j >= 0) & (j < cols)
                filled = (band <= kl) & (j >= 1) & in_cols
                in_pad = (band <= kl + 1) & in_cols
                nxt = dm + 1 < w_pad
                m_up = np.where(nxt, M[np.minimum(dm + 1, w_pad - 1)], NEG_INF).astype(i32)  # not yet written
                d_up = np.where(nxt, D[np.minimum(dm + 1, w_pad - 1)], NEG_INF).astype(i32)
                d_open, d_ext = m_up - i32(goe), d_up - i32(ge)
                d_cur = np.maximum(d_open, d_ext)
                diag = M[dm] + mrow[t[b, np.clip(t_base + dm, 0, T - 1)]]
                h_ng = np.maximum(diag, d_cur)
                h_c = np.where(filled, np.maximum(h_ng, 0), np.where(in_pad, 0, NEG_INF)).astype(i32)
                keyed = h_c + (dm * ge).astype(i32)
                incl = np.maximum.accumulate(keyed)
                prefix = np.maximum(np.concatenate([[NEG_INF], incl[:-1]]), carry).astype(i32)  # exclusive, after the carry
                carry = max(carry, int(incl[-1]))
                i_cur = np.where(filled, prefix - i32(go) - (dm * ge).astype(i32), NEG_INF).astype(i32)
                m_cur = np.where(filled, np.maximum(np.maximum(h_c, i_cur), 0), np.where(in_pad, 0, NEG_INF)).astype(i32)
                tb_m = np.where(d_cur > diag, 1, 0)
                tb_m = np.where(i_cur > h_ng, 2, tb_m)
                tb_m = np.where((np.maximum(h_ng, i_cur) <= 0) | ~filled, 3, tb_m)
                M[dm], D[dm], I[dm] = m_cur, d_cur, i_cur
                part = tb_m | np.where(d_open < d_ext, 4, 0)
                left = dm > 0
                m_left = np.where(left, M[np.maximum(dm - 1, 0)], NEG_INF).astype(i32)  # final: this or the last segment
                i_left = np.where(left, I[np.maximum(dm - 1, 0)], NEG_INF).astype(i32)
                tb[b, i - 1, dm] = part | np.where(m_left - i32(goe) < i_left - i32(ge), 8, 0)
                cand = np.where(filled, m_cur, INT32_MIN)
                if cand.max() > seg_best:  # strictly greater: the lowest lane keeps a tie
                    seg_best, seg_lane = int(cand.max()), int(dm[np.argmax(cand)])
            if seg_best > best:
                best, best_i, best_j = seg_best, i, j_base + seg_lane
        out[:, b] = best, best_i, best_j
    return tb, *out


@functools.lru_cache(maxsize=None)
def _jax_fill(go, ge, rows_max, w_pad):
    fill = functools.partial(jax_swg._fill_band, gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)
    return jax.jit(jax.vmap(fill, in_axes=(0, 0, 0, 0, 0, 0, None)))


def _assert_fill_model(arrays, matrix, go, ge, rows_max, w_pad, seg):
    q, ql, t, tl, off, kl = arrays
    want_tb, *want_best = (np.asarray(x) for x in _jax_fill(go, ge, rows_max, w_pad)(
        q.astype(np.int32), t.astype(np.int32), ql, tl, off, kl, matrix.astype(np.int32)))
    tb, *best = segmented_fill_model(q, ql, t, tl, off, kl, matrix, go, ge, rows_max, w_pad, seg)
    for name, g, x in zip(("best", "best_i", "best_j"), best, want_best):
        np.testing.assert_array_equal(g, x, err_msg=f"{name} seg={seg}")
    reached = np.arange(rows_max)[None, :, None] < ql[:, None, None]
    np.testing.assert_array_equal(np.where(reached, tb, 0), np.where(reached, want_tb, 0), err_msg=f"tb seg={seg}")


FILL_CASES = [
    # name, alphabet, matrix, gap_open, gap_extend, B, rows_max, w_pad, seeded, tie_heavy, segments
    ("protein-200", AA, blosum_matrix, 11, 1, 6, 96, 200, False, False, (64, 48)),
    ("nt-repeats-256", NT, nt_matrix, 4, 2, 6, 96, 256, False, True, (64, 48)),
    ("blosum-x20-300", AA, scaled_blosum, 220, 20, 5, 80, 300, False, True, (64,)),
    ("nt-seeded-131", NT, nt_matrix, 4, 2, 5, 64, 131, True, False, (48, 8192)),
]


@pytest.mark.parametrize("case", FILL_CASES, ids=[c[0] for c in FILL_CASES])
def test_segmented_fill_model_equals_jax(case):
    name, alphabet, matrix_fn, go, ge, B, rows_max, w_pad, seeded, ties, segments = case
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = random_swg_batch(rng, alphabet, B, rows_max, w_pad, seeded=seeded, tie_heavy=ties)
    for seg in segments:
        _assert_fill_model(arrays, matrix_fn(), go, ge, rows_max, w_pad, seg)


def test_segmented_fill_model_on_the_f7_pair():
    """The kernel's own geometry: w_pad 32,768 in four segments of 8,192 lanes."""
    arrays = f7_bucket(rows_max=160)
    _assert_fill_model(arrays, blosum_matrix(), 11, 1, 160, F7_W_PAD, 8192)


# ------------------------------------------------------------------------ the scans' sparse-table form


def pack_any_model(rows: np.ndarray, pad: int, length: int, k: int):
    """``pack_any`` over every stream position g < length (index pad + g of each row of n codes,
    wrapping past n): ``(fwd, rev, bad)`` as uint32, uint32 and bool arrays of (B, length)."""
    B, n = rows.shape
    g = np.arange(length)
    fwd = np.zeros((B, length), np.uint32)
    rev = np.zeros((B, length), np.uint32)
    bad = np.zeros((B, length), bool)
    for j in range(k):
        c = rows[:, (pad + g + j) % n].astype(np.uint32)
        bad |= c >= 4
        sf = 2 * (k - 1 - j)
        if sf < 32:  # a shift by 32 or more is dropped, as XLA's is 0
            fwd |= c << np.uint32(sf)
        if j < 16:
            rev |= (np.uint32(3) - c) << np.uint32(2 * j)
    return fwd, rev, bad


def _mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def scan_any_model(rows: np.ndarray, pad: int, length: int, k: int, w: int):
    """Stages 1-3 of the sparse-table form: ``(selected, hashes, strands, keys)`` of (B, length)."""
    fwd, rev, bad = pack_any_model(rows, pad, length, k)
    g = np.arange(length)
    valid = ~bad & (g < length - k + 1)
    hashes = np.where(valid, _mix32(np.minimum(fwd, rev)), np.uint32(U32)).astype(np.uint32)
    keys = (hashes.astype(np.uint64) << np.uint64(32)) | g.astype(np.uint64)
    selected = np.zeros(hashes.shape, bool)
    n_starts = length - k - w + 2
    if n_starts > 0:
        a = 0
        while (2 << a) <= w:
            a += 1
        span = keys
        for j in range(a):  # min over 2^(j+1) positions from two spans of 2^j
            step = 1 << j
            nxt = span.copy()
            nxt[:, : length - step] = np.minimum(span[:, : length - step], span[:, step:])
            span = nxt
        s = np.arange(n_starts)
        m = np.minimum(span[:, s], span[:, s + w - (1 << a)])
        live = (m >> np.uint64(32)) != np.uint64(U32)
        b_idx = np.broadcast_to(np.arange(rows.shape[0])[:, None], m.shape)
        selected[b_idx[live], (m[live] & np.uint64(U32)).astype(np.int64)] = True  # selection by scatter
    return selected, hashes, fwd <= rev, keys


def rowcompact_any_model(codes_padded: np.ndarray, k: int, w: int):
    """The row-compact sparse-table form: ``(hashes, aux, counts)`` as int32 arrays."""
    B, r_pad, row = codes_padded.shape
    R = r_pad - 16
    selected, _, strands, keys = scan_any_model(codes_padded.reshape(B, -1), 8 * row, R * row, k, w)
    hashes = np.full((B, R, 64), -1, np.int32)
    aux = np.full((B, R, 64), -1, np.int32)
    sel = selected.reshape(B, R, row)
    h = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32).reshape(B, R, row)
    a = (np.arange(row) | (strands.reshape(B, R, row).astype(np.int32) << 7)).astype(np.int32)
    for b in range(B):
        for r in range(R):
            cols = np.flatnonzero(sel[b, r])[:64]  # ranks in position order
            hashes[b, r, : len(cols)] = h[b, r, cols]
            aux[b, r, : len(cols)] = a[b, r, cols]
    return hashes, aux, sel.sum(-1, dtype=np.int32)[..., None]


SCAN_KW = [(15, 33), (15, 200), (15, 1000), (15, 1100), (17, 10), (20, 33), (31, 40), (31, 1), (32, 5), (1, 1),
           (15, 2999)]


@pytest.mark.parametrize("kw", SCAN_KW, ids=[f"k{k}-w{w}" for k, w in SCAN_KW])
def test_flat_scan_any_model_equals_jax(kw):
    k, w = kw
    codes = flat_panel()
    codes[-3:] = (2, 4, 1)  # k-mers rolling over the end hold a sentinel and valid bases
    got = scan_any_model(codes[None], 0, len(codes), k, w)[:3]
    want = jax_minimizer.minimizer_scan_host(codes, k, w)
    for name, g, x in zip(("selected", "hashes", "strands"), got, want):
        np.testing.assert_array_equal(g[0], x, err_msg=name)


@pytest.mark.parametrize("k", [17, 31])
def test_flat_scan_any_model_equals_jitted_scan(k):
    codes = flat_panel()
    got = scan_any_model(codes[None], 0, len(codes), k, 7)[:3]
    for name, g, x in zip(("selected", "hashes", "strands"), got, jax_minimizer.minimizer_scan(codes, k, 7)):
        np.testing.assert_array_equal(g[0], np.asarray(x), err_msg=name)


@pytest.mark.parametrize("kw", [(15, 33), (15, 1100), (20, 33), (31, 40), (16, 10)], ids=str)
def test_rowcompact_any_model_equals_jax(kw):
    k, w = kw
    codes = rowcompact_panel()
    got = rowcompact_any_model(codes, k, w)
    want = [np.asarray(x) for x in jax_scan.rowcompact_scan_xla(codes, k, w)]
    for name, g, x in zip(("hashes", "aux", "counts"), got, want):
        np.testing.assert_array_equal(g, x.view(np.int32), err_msg=name)
    assert int(got[2].max()) > 0
