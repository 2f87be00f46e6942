"""Numpy models of the two kernel forms redesigned for Hopper after the input range was closed,
held to the JAX package on the CPU.

A CUDA kernel cannot run here, so the algorithm each form runs is written out in
numpy, step for step, and held to the reference:

- ``csrc/swg.cu::swg_fill_cluster_kernel``, the fill's cluster form: the band
  cut into CTA slices of ``slice`` lanes (2,048, 4,096 and 8,192 in the
  kernel's geometry), each slice into warps of ``32 x LPT`` lanes whose M and D
  stay with the warp from row to row.  A row is two phases a warp: pass 1 (D,
  the diagonal, H) ends in the warp's publications for the row (its scan
  total, its first lane's H, D and flags, its last lane's exclusive prefix, H
  and flags), and each CTA then pushes its total to every CTA on its right,
  its first lane to its left neighbour and its last lane to its right one;
  pass 2 takes the scan's prefix from the carry of the CTAs before, the warps
  before and the warp's own lanes, and rebuilds the final M and I of the lane
  before its first (for the I-state bit) and the final M and D of the lane
  after its last (for the next row) from those publications alone.  The
  publications are double-buffered by row parity and the model runs the
  latest order the barriers allow: each warp, CTA after CTA, finishes its row
  and runs pass 1 of the next row (and each CTA pushes the next row's values)
  before the next warp reads this row's.  The best cell is kept per thread
  of LPT lanes (strictly greater, rows then lanes in order) and reduced at the
  end by (highest score, lowest row, lowest lane).  Held to the JAX package's
  ``_fill_band`` (traceback bits on the rows the query reaches, best score,
  row and column) beside the segmented form's model.
- ``csrc/viterbi.cu::arch_viterbi_wide_kernel``, the architectural decode past
  256 states (its states cut among the CTAs of a cluster, each state's pick
  made whole by one warp, so the cut leaves every pick as the model makes it):
  a warp a state over the transitions transposed and padded to a
  multiple of 4 with ``-inf``; lane l scans the predecessors of float4 chunks
  l, l + 32, ... and then the tail past the last whole round of 32 chunks one
  at a time, with the strict ``>`` (lane 0 takes its first candidate as it
  is); the warp reduces its 32 (value, index) pairs by the greatest
  order-preserving key (-0 as +0, NaN above every number) and then the lowest
  index, as the kernel's two warp reductions do, or by a butterfly shuffle
  tree over the same (key, lower index) rule.  Held to the JAX
  ``architectural_viterbi`` and to ``arch_viterbi_plain`` at S = 257, 300 and
  1,027 with tied candidates, ``-inf`` transitions and ``-inf`` rows, and to
  a strict chain over the predecessors where candidates are NaN.

Tolerance: exact.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from range_panels import F7_W_PAD, WIDE_MATRICES, f7_bucket
from swg_panels import AA, NT, blosum_matrix, nt_matrix, random_swg_batch
from viterbi_panels import arch_chain_reference, arch_tie_panel

from kaptive_tpu.bgc.kernels import architectural_viterbi
from kaptive_tpu.ops import swg as jax_swg

torch.set_num_threads(1)  # the plain decode issues many tiny ops

NEG_INF = -1_000_000_000
INT32_MIN = np.iinfo(np.int32).min
I32 = np.int32


# ------------------------------------------------------------------------------- the cluster fill


def _w32(x: int) -> int:
    """``x`` wrapped to int32, as the kernel's int32 arithmetic wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _h_c(h_ng, flags):
    return np.where(flags & 16, np.maximum(h_ng, 0), np.where(flags & 32, 0, NEG_INF)).astype(I32)


def _final(h_ng: int, flags: int, prefix: int, dm: int, go: int, ge: int) -> tuple[int, int]:
    """A lane's final ``(M, I)`` of the row rebuilt from what its owner published (``cl_final``)."""
    if not flags & 16:
        return (0 if flags & 32 else NEG_INF), NEG_INF
    i_cur = _w32(prefix - go - _w32(dm * ge))
    return max(max(h_ng, 0), i_cur, 0), i_cur


def _row0_m(dm: int, w_pad: int, off: int, k_pad: int, kl: int, cols: int) -> int:
    j0 = dm - off - k_pad - 1
    return 0 if dm < w_pad and abs(dm - (k_pad + 1)) <= kl + 1 and 0 <= j0 < cols else NEG_INF


class _Warp:
    """One warp's lanes [lo, hi) of the band, in CTA ``rank``'s slice ending at ``end``."""

    def __init__(self, rank, w, lo, hi, end, w_pad, off, k_pad, kl, cols, lpt):
        self.rank, self.w, self.lo, self.hi, self.end = rank, w, lo, hi, end
        dm = np.arange(lo, hi)
        self.M = np.array([_row0_m(int(x), w_pad, off, k_pad, kl, cols) for x in dm], I32)
        self.D = np.full(hi - lo, NEG_INF, I32)
        self.right = (_row0_m(hi, w_pad, off, k_pad, kl, cols), NEG_INF)  # lane hi's M and D, the row above
        n_threads = -(-(hi - lo) // lpt)
        self.best = np.zeros(n_threads, np.int64)  # each thread's (score, row, lane)
        self.best_row = np.zeros(n_threads, np.int64)
        self.best_lane = np.zeros(n_threads, np.int64)


def cluster_fill_model(q, q_lens, t, t_lens, offsets, k_locals, matrix, go, ge, rows_max, w_pad, slice_, lpt):
    """``swg_fill_cluster_kernel`` with CTA slices of ``slice_`` lanes and ``lpt`` lanes a thread:
    ``(tb, best, best_i, best_j)``, rows past a query left at 0."""
    B, T = q.shape[0], t.shape[1]
    k_pad = (w_pad - 3) // 2
    goe = go + ge
    C = -(-w_pad // slice_)
    assert (C - 1) * slice_ < w_pad, "every CTA holds lanes"
    lanes_a_warp = 32 * lpt
    tb = np.zeros((B, rows_max, w_pad), np.uint8)
    out = np.zeros((3, B), np.int64)
    for b in range(B):
        cols, off, kl = int(t_lens[b]) + 1, int(offsets[b]), int(k_locals[b])
        n_rows = min(int(q_lens[b]), rows_max)
        if n_rows <= 0:
            continue
        ctas = []
        for r in range(C):
            s0, n = r * slice_, min(slice_, w_pad - r * slice_)
            ctas.append([_Warp(r, w, s0 + x, s0 + min(x + lanes_a_warp, n), s0 + n, w_pad, off, k_pad, kl, cols, lpt)
                         for w, x in enumerate(range(0, n, lanes_a_warp))])
        # slots[parity]: the warps' publications and what the CTAs pushed, written and read by row parity
        slots = [dict(wtot={}, wfirst={}, wlast={}, tot_in={}, right={}, left={}) for _ in range(2)]

        def pass1(u: _Warp, i: int):
            dm = np.arange(u.lo, u.hi)
            mrow = matrix[int(q[b, i - 1])].astype(I32)
            j = i - off - k_pad - 1 + dm
            band = np.abs(dm - (k_pad + 1))
            in_cols = (j >= 0) & (j < cols)
            filled, in_pad = (band <= kl) & (j >= 1) & in_cols, (band <= kl + 1) & in_cols
            m_up = np.append(u.M[1:], I32(u.right[0]))
            d_up = np.append(u.D[1:], I32(u.right[1]))
            d_open, d_ext = m_up - I32(goe), d_up - I32(ge)
            d = np.maximum(d_open, d_ext)
            diag = u.M + mrow[t[b, np.clip(i - off + w_pad - k_pad + dm, 0, T - 1)]]
            u.h_ng = np.maximum(diag, d).astype(I32)
            u.flags = ((d > diag) * 1 | (d_open < d_ext) * 4 | filled * 16 | in_pad * 32).astype(np.int64)
            u.D = d.astype(I32)
            u.keys = (_h_c(u.h_ng, u.flags) + (dm * ge).astype(I32)).astype(I32)
            s = slots[i & 1]
            s["wtot"][u.rank, u.w] = max(NEG_INF, int(u.keys.max()))
            s["wfirst"][u.rank, u.w] = (int(u.h_ng[0]), int(u.D[0]), int(u.flags[0]))
            s["wlast"][u.rank, u.w] = (max([NEG_INF, *u.keys[:-1].tolist()]), int(u.h_ng[-1]), int(u.flags[-1]))

        def push(r: int, i: int):
            s = slots[i & 1]
            tots = [s["wtot"][r, w] for w in range(len(ctas[r]))]
            for r2 in range(r + 1, C):
                s["tot_in"][r2, r] = max(tots)
            if r > 0:
                s["right"][r - 1] = s["wfirst"][r, 0]
            if r + 1 < C:
                wl = len(ctas[r]) - 1
                pre, h, f = s["wlast"][r, wl]
                s["left"][r + 1] = (max([pre, *tots[:wl]]), h, f)

        def pass2(u: _Warp, i: int):
            s = slots[i & 1]
            r, w = u.rank, u.w
            ins = [s["tot_in"][r, x] for x in range(r)]
            carry, carry_left = max([NEG_INF, *ins]), max([NEG_INF, *ins[:-1]])
            tots = [s["wtot"][r, x] for x in range(len(ctas[r]))]
            wpre, wpre_left, wpre_incl = (max([NEG_INF, *tots[:k]]) for k in (w, w - 1 if w else 0, w + 1))
            dm = np.arange(u.lo, u.hi)
            lane_ge = (dm * ge).astype(I32)
            excl = np.concatenate([[NEG_INF], np.maximum.accumulate(u.keys)[:-1]])
            prefix = np.maximum(excl, max(wpre, carry)).astype(I32)
            filled, in_pad = (u.flags & 16) > 0, (u.flags & 32) > 0
            h_c = _h_c(u.h_ng, u.flags)
            i_cur = np.where(filled, prefix - I32(go) - lane_ge, NEG_INF).astype(I32)
            m_cur = np.where(filled, np.maximum(np.maximum(h_c, i_cur), 0), np.where(in_pad, 0, NEG_INF)).astype(I32)
            tb_m = np.where(u.flags & 1, 1, 0)
            tb_m = np.where(i_cur > u.h_ng, 2, tb_m)
            tb_m = np.where((np.maximum(u.h_ng, i_cur) <= 0) | ~filled, 3, tb_m)
            if w > 0:
                pre, h, f = s["wlast"][r, w - 1]
                left = _final(h, f, max(carry, wpre_left, pre), u.lo - 1, go, ge)
            elif r > 0:
                pre, h, f = s["left"][r]
                left = _final(h, f, max(carry_left, pre), u.lo - 1, go, ge)
            else:
                left = (NEG_INF, NEG_INF)
            m_left = np.concatenate([[left[0]], m_cur[:-1]]).astype(I32)
            i_left = np.concatenate([[left[1]], i_cur[:-1]]).astype(I32)
            tb[b, i - 1, u.lo:u.hi] = tb_m | (u.flags & 4) | np.where(m_left - I32(goe) < i_left - I32(ge), 8, 0)
            u.M = m_cur
            if u.hi == u.end:  # the slice's last lane: the right CTA's first, else the band's end
                if r + 1 < C:
                    h, d, f = s["right"][r]
                    u.right = (_final(h, f, max(carry, max(tots)), u.hi, go, ge)[0], d)
                else:
                    u.right = (NEG_INF, NEG_INF)
            else:
                h, d, f = s["wfirst"][r, w + 1]
                u.right = (_final(h, f, max(carry, wpre_incl), u.hi, go, ge)[0], d)
            cand = np.full(len(u.best) * lpt, INT32_MIN, np.int64)
            cand[: u.hi - u.lo] = np.where(filled, m_cur, INT32_MIN)
            cand = cand.reshape(-1, lpt)
            top, at = cand.max(axis=1), cand.argmax(axis=1)  # a thread's first lane of its row maximum
            take = top > u.best  # strictly greater: the thread's earliest row keeps a tie
            u.best[take], u.best_row[take] = top[take], i
            u.best_lane[take] = u.lo + lpt * np.flatnonzero(take) + at[take]

        for cta in ctas:
            for u in cta:
                pass1(u, 1)
        for r in range(C):
            push(r, 1)
        for i in range(1, n_rows + 1):  # the latest order the barriers allow
            for r, cta in enumerate(ctas):
                for u in cta:
                    pass2(u, i)
                    if i < n_rows:
                        pass1(u, i + 1)
                if i < n_rows:
                    push(r, i + 1)
        bests = [(-int(v), int(rw), int(ln)) for u in (u for cta in ctas for u in cta)
                 for v, rw, ln in zip(u.best, u.best_row, u.best_lane)]
        v, rw, ln = min(bests)
        if -v > 0:
            out[:, b] = -v, rw, rw - off - k_pad - 1 + ln
    return tb, *out


@functools.lru_cache(maxsize=None)
def _jax_fill(go, ge, rows_max, w_pad):
    fill = functools.partial(jax_swg._fill_band, gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)
    return jax.jit(jax.vmap(fill, in_axes=(0, 0, 0, 0, 0, 0, None)))


def _assert_cluster_model(arrays, matrix, go, ge, rows_max, w_pad, geometries):
    q, ql, t, tl, off, kl = arrays
    want_tb, *want_best = (np.asarray(x) for x in _jax_fill(go, ge, rows_max, w_pad)(
        q.astype(np.int32), t.astype(np.int32), ql, tl, off, kl, matrix.astype(np.int32)))
    reached = np.arange(rows_max)[None, :, None] < ql[:, None, None]
    for slice_, lpt in geometries:
        tb, *best = cluster_fill_model(q, ql, t, tl, off, kl, matrix, go, ge, rows_max, w_pad, slice_, lpt)
        for name, g, x in zip(("best", "best_i", "best_j"), best, want_best):
            np.testing.assert_array_equal(g, x, err_msg=f"{name} slice={slice_} lpt={lpt}")
        np.testing.assert_array_equal(np.where(reached, tb, 0), np.where(reached, want_tb, 0),
                                      err_msg=f"tb slice={slice_} lpt={lpt}")
    return want_best


def test_cluster_fill_model_on_the_f7_pair():
    """The kernel's geometry at w_pad 32,768: 16 CTAs of 2,048 lanes (4 a thread), 8 of 4,096 (8)
    and 4 of 8,192 (16); the JAX package's score 849 at row 150."""
    arrays = f7_bucket(rows_max=160)
    best = _assert_cluster_model(arrays, blosum_matrix(), 11, 1, 160, F7_W_PAD, ((2048, 4), (4096, 8), (8192, 16)))
    assert best[0][0] == 849


def _planted_tie_panel(slice_: int, n: int = 20, rows_max: int = 24):
    """Pairs whose best score (all n matches) is reached in one row at lanes 3 apart on both
    sides of the slice boundary at lane ``slice_``: a period-3 query against a target that holds
    the same repeat for n + 9 bases, at the diagonal offset that puts the full matches' end
    cells in lanes ``slice_ - 4 + p`` .. ``slice_ + 5 + p`` (pair p).  The lowest lane must win."""
    w_pad = 4 * slice_ + 1
    k_pad = (w_pad - 3) // 2
    t_pad = w_pad + 2
    rng = np.random.default_rng(slice_)
    alpha = np.frombuffer(NT, np.uint8)
    period = np.frombuffer(b"ACG", np.uint8)
    B = 3
    q = np.zeros((B, rows_max), np.uint8)
    t = np.zeros((B, rows_max + 2 * t_pad), np.uint8)
    q_lens, t_lens, offsets, k_locals = (np.zeros(B, np.int32) for _ in range(4))
    for p in range(B):
        off = -(slice_ + 8)
        c0 = slice_ - 4 + p - off - k_pad - 1  # a full match from target base c ends in lane c + off + k_pad + 1
        target = alpha[rng.integers(0, 4, 2 * k_pad - 4)]
        target[target == ord("T")] = ord("A")
        target[c0 - 1], target[c0 + n + 9] = ord("T"), ord("T")  # the repeat stops on both sides
        target[c0: c0 + n + 9] = np.resize(period, n + 9)
        q[p, :n], t[p, t_pad: t_pad + len(target)] = np.resize(period, n), target
        q_lens[p], t_lens[p], offsets[p], k_locals[p] = n, len(target), off, k_pad
    return (q, q_lens, t, t_lens, offsets, k_locals), w_pad


FILL_CASES = [
    # name, alphabet, matrix, gap_open, gap_extend, B, rows_max, w_pad, seeded, tie_heavy, (slice, lpt) geometries
    ("protein-300", AA, blosum_matrix, 11, 1, 5, 64, 300, False, False, ((128, 4), (256, 8), (512, 16))),
    ("nt-repeats-1100", NT, nt_matrix, 4, 2, 5, 48, 1100, False, True, ((128, 4), (384, 4), (1100, 16))),
    ("blosum-x20-520", AA, WIDE_MATRICES["blosum62-x20"][1], 220, 20, 5, 48, 520, False, True, ((132, 4), (264, 8))),
    ("nt-100000-seeded-131", NT, WIDE_MATRICES["nt-100000"][1], 400_000, 100_000, 6, 48, 131, True, True,
     ((131, 4), (32, 4), (48, 16))),
]


@pytest.mark.parametrize("case", FILL_CASES, ids=[c[0] for c in FILL_CASES])
def test_cluster_fill_model_equals_jax(case):
    """Random panels at several slice widths and lanes a thread, every band crossing slices."""
    name, alphabet, matrix_fn, go, ge, B, rows_max, w_pad, seeded, ties, geometries = case
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = random_swg_batch(rng, alphabet, B, rows_max, w_pad, seeded=seeded, tie_heavy=ties)
    if not seeded:
        arrays[5][:] = np.maximum(arrays[5], (w_pad - 3) // 2 - 8)  # bands across every slice
    _assert_cluster_model(arrays, matrix_fn(), go, ge, rows_max, w_pad, geometries)


@pytest.mark.parametrize("slice_", [128, 256])
def test_cluster_fill_model_keeps_the_lowest_lane_across_a_slice_boundary(slice_):
    """Equal best scores on the two sides of a slice boundary in one row: the lower lane wins,
    as the per-row rule has it, though CTA 1 holds the other cells of the tie."""
    arrays, w_pad = _planted_tie_panel(slice_)
    best = _assert_cluster_model(arrays, nt_matrix(), 4, 2, 24, w_pad, ((slice_, 4), (slice_, 8)))
    k_pad = (w_pad - 3) // 2
    assert best[0].tolist() == [40, 40, 40] and best[1].tolist() == [20, 20, 20]
    lanes = best[2] - best[1] + arrays[4] + k_pad + 1
    assert lanes.tolist() == [slice_ - 4, slice_ - 3, slice_ - 2]


def test_cluster_fill_model_with_blosum62_x20():
    """BLOSUM62 x 20 (int32 scores) at the widths the protein buckets take: one warp a pair at
    w_pad 128 and 512 (slices as wide as the band), a cluster of three at 1,152."""
    alphabet, matrix_fn, go, ge = WIDE_MATRICES["blosum62-x20"]
    rng = np.random.default_rng(20)
    for w_pad, geometries in ((128, ((128, 4),)), (512, ((512, 16),)), (1152, ((384, 4), (1152, 16)))):
        arrays = random_swg_batch(rng, alphabet, 6, 64, w_pad, seeded=False, tie_heavy=True)
        _assert_cluster_model(arrays, matrix_fn(), go, ge, 64, w_pad, geometries)


# ------------------------------------------------------------------- the warp-a-state decode


def _pick_key(v: np.ndarray) -> np.ndarray:
    """``pick_key``: an order-preserving uint32 of float32 values, -0 as +0, NaN above every number."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), key).astype(np.uint32)


def _lane_order(S: int) -> tuple[np.ndarray, int]:
    """Each lane's predecessors in the order it scans them (-1 past its last) and the first of
    the tail scanned one at a time."""
    n_chunks = -(-S // 4)
    whole = n_chunks // 32 * 32
    tail = 4 * whole
    order = []
    for lane in range(32):
        ps = [4 * c + k for c in range(lane, whole, 32) for k in range(4)] + list(range(tail + lane, S, 32))
        order.append(ps)
    width = max(len(p) for p in order)
    return np.array([p + [-1] * (width - len(p)) for p in order]), tail


def warp_pick(cand: np.ndarray, S: int, reduce: str = "redux") -> tuple[np.ndarray, np.ndarray]:
    """``(best, arg)`` of every state's candidates ``cand`` (a row a state, S predecessors padded
    with -inf to a multiple of 4) as a warp picks them: the lanes' strict scans, then ``reduce``,
    the kernel's two warp reductions ("redux") or a butterfly shuffle tree ("tree") over
    (key, lower index)."""
    n_states = cand.shape[0]
    order, tail = _lane_order(S)
    best = np.full((n_states, 32), -np.inf, np.float32)
    arg = np.tile(np.where(order[:, 0] >= 0, order[:, 0], 0), (n_states, 1))
    for k in range(order.shape[1]):
        p = order[:, k]
        live = p >= 0
        c = np.where(live, cand[:, np.maximum(p, 0)], -np.inf).astype(np.float32)
        take = live & ((c > best) | (p == 0))  # lane 0 takes its first candidate as it is
        best, arg = np.where(take, c, best), np.where(take, p, arg)
    key = _pick_key(best)
    if reduce == "redux":
        top = key.max(axis=1, keepdims=True)
        win = np.where(key == top, arg, np.iinfo(np.int64).max).min(axis=1)
    else:
        k, a = key.astype(np.int64), arg.copy()
        for d in (16, 8, 4, 2, 1):
            ok, oa = k[:, np.arange(32) ^ d], a[:, np.arange(32) ^ d]
            other = (ok > k) | ((ok == k) & (oa < a))
            k, a = np.where(other, ok, k), np.where(other, oa, a)
        win = a[:, 0]
    holder = np.where(win < tail, (win >> 2) & 31, (win - tail) & 31)
    return best[np.arange(n_states), holder], win


def warp_state_decode(emissions, transitions, offsets, reduce: str = "redux"):
    """``arch_viterbi_wide_kernel``: ``(paths, scores)``."""
    S = transitions.shape[0]
    pitch = -(-S // 4) * 4
    tt = np.full((S, pitch), -np.inf, np.float32)
    tt[:, :S] = transitions.T
    paths = np.empty(int(offsets[-1]), np.int32)
    scores = np.empty(len(offsets) - 1, np.float32)
    for c, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
        rows = emissions[lo:hi]
        prev = np.full(pitch, -np.inf, np.float32)
        prev[:S] = transitions[0] + rows[0]
        back = np.zeros((len(rows), S), np.int64)
        for i in range(1, len(rows)):
            best, back[i] = warp_pick(prev[None, :] + tt, S, reduce)
            prev[:S] = best + rows[i]
        scores[c] = prev[S - 1]
        state = S - 1
        paths[hi - 1] = state
        for i in range(len(rows) - 1, 0, -1):
            state = back[i, state]
            paths[lo + i - 1] = state
    return paths, scores


def _decode_panel(S: int):
    em, trans, offsets = arch_tie_panel(np.random.default_rng(S), [1, 3, 12, 30], S)
    em[20] = -np.inf  # a row every state of which is -inf
    return em, trans, offsets


@pytest.mark.parametrize("S", [257, 300, 1027])
@pytest.mark.parametrize("reduce", ["redux", "tree"])
def test_warp_state_decode_equals_jax(S, reduce):
    em, trans, offsets = _decode_panel(S)
    got_p, got_s = warp_state_decode(em, trans, offsets, reduce)
    for c, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
        if hi - lo == 1:
            assert got_p[lo] == S - 1 and got_s[c] == trans[0, S - 1] + em[lo, S - 1]
            continue
        want_p, want_s = architectural_viterbi(em[lo:hi], trans)
        np.testing.assert_array_equal(got_p[lo:hi], np.asarray(want_p))
        assert got_s[c] == np.float32(want_s) or (np.isneginf(got_s[c]) and np.isneginf(want_s))


@pytest.mark.parametrize("S", [257, 300, 1027])
def test_warp_state_decode_equals_plain(S):
    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain

    em, trans, offsets = _decode_panel(S)
    got_p, got_s = warp_state_decode(em, trans, offsets)
    want_p, want_s = arch_viterbi_plain(*(torch.from_numpy(a) for a in (em, trans, offsets)))
    np.testing.assert_array_equal(got_p, want_p.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())


def test_warp_pick_keeps_the_lowest_index_and_a_first_nan():
    """Ties across lanes and across the float4 chunks and the tail go to the lowest predecessor;
    a NaN is kept only as a state's first candidate (p = 0), as one strict chain keeps it."""
    S = 300
    cand = np.full((4, 300), -np.inf, np.float32)
    cand[0, [299, 4, 130, 257]] = 5.0
    cand[1, [256, 3]] = 7.0
    cand[2, 0], cand[2, 5] = np.nan, 9.0
    cand[3, 1], cand[3, [6, 290]] = np.nan, -0.0
    cand[3, 2] = 0.0
    best, arg = warp_pick(cand, S)
    assert arg.tolist() == [4, 3, 0, 2] and best[0] == 5.0 and best[1] == 7.0 and np.isnan(best[2])
    for reduce in ("redux", "tree"):
        np.testing.assert_array_equal(warp_pick(cand, S, reduce)[1], arg)
    assert cand.shape[1] == S


@pytest.mark.parametrize("S", [257, 300])
def test_warp_state_decode_equals_the_strict_chain_with_nans(S):
    em, trans, offsets = arch_tie_panel(np.random.default_rng(7 * S), [1, 6, 40], S)
    em[3, :5] = np.nan
    em[20, np.random.default_rng(S).integers(1, S, 30)] = np.nan
    got = warp_state_decode(em, trans, offsets)
    want = arch_chain_reference(em, trans, offsets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
