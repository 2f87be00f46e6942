r"""Batched banded Smith-Waterman-Gotoh: front door, shape lattice, plain PyTorch version.

Counterpart of :mod:`kaptive_tpu.ops.swg`.  The DP is the same banded local
SWG with the same band geometry (a ``w_pad``-lane band in diagonal
coordinates, border cells scoring 0), the same lazy-F max-plus scan for the
horizontal gap state, the same packed traceback bits and the same tie rules,
so every :class:`SwgResult` field equals ``banded_swg_lax``'s exactly.

:func:`banded_swg` routes by the device of its tensors: a CUDA tensor goes to
the hand-written Hopper kernels (:mod:`kaptive_tpu_torch.ops.swg_cuda`) or
raises; a CPU tensor goes to :func:`banded_swg_plain`, the plain PyTorch
version (one vectorised step per DP row, batched over pairs).  The plain
version also runs on CUDA tensors when called directly, which is how the
kernels are checked on the card.

:class:`SwgLattice` and :func:`plan_swg_buckets` are re-homed unchanged from
the JAX module (which imports ``jax`` at the top); the bucket plan decides
padding only, never results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from kaptive_tpu.utils.metrics import count

NEG_INF = -1_000_000_000


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True, slots=True)
class SwgLattice:
    r"""A frozen set of DP bucket shapes (``kaptive_tpu.ops.swg.SwgLattice``).

    ONE row count (or ascending row tiers), a small tuple of band widths and
    one batch size (larger pair sets dispatch in chunks, the final remainder
    of a wider band in ``tail_batch``).  Pairs outside the lattice fall back
    to dynamic bucketing and are counted under ``swg.offlattice``.
    """

    rows: int  # largest rows_max tier (% 64 == 0)
    widths: tuple[int, ...]  # ascending band widths (% 128 == 0)
    batch: int = 128  # pairs per dispatch (% 8 == 0)
    row_tiers: tuple[int, ...] = ()
    tail_batch: int = 0

    @classmethod
    def for_max_len(cls, max_len: int, *, len_slack: int = 0, widths: tuple[int, ...] | None = None, batch: int = 128, row_tiers: tuple[int, ...] = (), tail_batch: int = 0) -> SwgLattice:
        r"""Build a lattice covering pairs up to ``max_len + len_slack``.

        The default width set is (128, W/2, W) where W covers the worst
        unseeded band ``2*(max_len+1)+3``.
        """
        rows = round_up(max(int(max_len) + int(len_slack), 64), 64)
        if widths is None:
            wide = round_up(2 * int(max_len) + 5, 128)
            mid = round_up(wide // 2, 128)
            widths = (128,) + tuple(w for w in (mid, wide) if w > 128)
        return cls(rows, tuple(int(w) for w in widths), int(batch),
                   tuple(int(r) for r in row_tiers), int(tail_batch))

    @property
    def tiers(self) -> tuple[int, ...]:
        return self.row_tiers if self.row_tiers else (self.rows,)


def plan_swg_buckets(
    joint: np.ndarray, w_needed: np.ndarray, lattice: SwgLattice | None,
    *, dyn_min_size: int = 256, dyn_min_w: int = 128, dyn_factor: int = 4,
    min_batch: int = 16,
) -> list[tuple[np.ndarray, int, int, int]]:
    r"""Assign pairs to bucket shapes: a list of ``(pair_indices, rows_max, w_pad, b_pad)``.

    Same plan as ``kaptive_tpu.ops.swg.plan_swg_buckets``: in-range pairs share
    the lattice's shapes (chunked at ``lattice.batch``); out-of-range pairs (and
    all pairs when no lattice is given) use power-of-``dyn_factor`` bucketing
    with x4 batch quantisation.
    """

    def dyn_bucket(x: int, minimum: int) -> int:
        size = minimum
        while size < x:
            size *= dyn_factor
        return size

    n = len(joint)
    rows_of = np.empty(n, dtype=np.int64)
    w_of = np.empty(n, dtype=np.int64)
    on_lattice = np.zeros(n, dtype=bool)
    if lattice is not None:
        widths = np.asarray(lattice.widths, dtype=np.int64)
        tiers = np.asarray(lattice.tiers, dtype=np.int64)
        wi = np.searchsorted(widths, np.asarray(w_needed, dtype=np.int64))
        ri = np.searchsorted(tiers, np.asarray(joint, dtype=np.int64))
        on_lattice = (ri < len(tiers)) & (wi < len(widths))
        rows_of[on_lattice] = tiers[ri[on_lattice]]
        w_of[on_lattice] = widths[wi[on_lattice]]
    off = ~on_lattice
    if off.any():
        if lattice is not None:
            count("swg.offlattice", int(off.sum()))
        rows_of[off] = [dyn_bucket(int(s), dyn_min_size) for s in joint[off]]
        w_of[off] = [dyn_bucket(int(w), dyn_min_w) for w in w_needed[off]]

    groups: list[tuple[np.ndarray, int, int, int]] = []
    keys = rows_of * 10**6 + w_of
    for key in np.unique(keys):
        sel = np.nonzero(keys == key)[0]
        rows_max = int(rows_of[sel[0]])
        w_pad = int(w_of[sel[0]])
        if lattice is not None and bool(on_lattice[sel[0]]):
            b_fix = -(-lattice.batch // min_batch) * min_batch
            t_fix = -(-lattice.tail_batch // min_batch) * min_batch if lattice.tail_batch else 0
            for start in range(0, len(sel), b_fix):
                part = sel[start : start + b_fix]
                b_here = (
                    t_fix
                    if (t_fix and len(part) <= t_fix and w_pad > lattice.widths[0])
                    else b_fix
                )
                groups.append((part, rows_max, w_pad, b_here))
        else:
            b = len(sel)
            b_pad = min_batch
            while b_pad < b:
                b_pad *= 4
            groups.append((sel, rows_max, w_pad, b_pad))
    return groups


class SwgResult(NamedTuple):
    r"""Flat per-pair alignment statistics (mirrors ``PairwiseAlignments`` fields)."""

    scores: torch.Tensor
    matches: torch.Tensor
    mismatches: torch.Tensor
    gaps: torch.Tensor
    q_starts: torch.Tensor
    q_ends: torch.Tensor
    t_starts: torch.Tensor
    t_ends: torch.Tensor


def fill_band_plain(
    q_codes: torch.Tensor,  # (B, rows_max) uint8
    q_lens: torch.Tensor,  # (B,) int32
    t_codes: torch.Tensor,  # (B, T) uint8, padded by w_pad + 2 on the left
    t_lens: torch.Tensor,  # (B,) int32
    offsets: torch.Tensor,  # (B,) int32 diagonal offsets (q_pos - t_pos)
    k_locals: torch.Tensor,  # (B,) int32 per-pair half band widths
    matrix: torch.Tensor,  # (256, 256) substitution scores
    *,
    gap_open: int,
    gap_extend: int,
    rows_max: int,
    w_pad: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Plain PyTorch band fill (``kaptive_tpu.ops.swg._fill_band``, batched over pairs).

    Returns ``(tb, best, best_i, best_j)``: packed traceback bits
    ``(B, rows_max, w_pad)`` uint8 and the running best cell.  One vectorised
    step per DP row; ``torch.cummax`` is the lazy-F max-plus scan.  Rows past
    the longest query are skipped and their bits left at zero (no filled cell
    lives there and the traceback never reads them).  The target window is
    clamped per element into ``[0, T)``; clamped lanes are masked, as in the
    Pallas kernel.
    """
    count("swg.plain.fill")
    dev = q_codes.device
    i32 = torch.int32
    B, T = q_codes.shape[0], t_codes.shape[1]
    k_pad = (w_pad - 3) // 2
    pad = w_pad + 2
    goe = gap_open + gap_extend
    ge = gap_extend

    neg = torch.tensor(NEG_INF, dtype=i32, device=dev)
    zero = torch.tensor(0, dtype=i32, device=dev)
    neg_col = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)
    dm = torch.arange(w_pad, dtype=i32, device=dev)[None, :]
    dm_ge = dm * ge
    q = q_codes.to(torch.int64)
    t = t_codes.to(torch.int64)
    mat = matrix.to(device=dev, dtype=i32).reshape(-1)
    l1 = q_lens.to(dev, i32)[:, None]
    cols = t_lens.to(dev, i32)[:, None] + 1
    off = offsets.to(dev, i32)[:, None]
    kl = k_locals.to(dev, i32)[:, None]
    band = (dm - (k_pad + 1)).abs()
    in_band = band <= kl
    in_band_pad = band <= kl + 1

    # Row 0: padded-band border cells get M=0, everything else -INF.
    j0 = dm - off - k_pad - 1
    m = torch.where(in_band_pad & (j0 >= 0) & (j0 < cols), zero, neg)
    d = torch.full((B, w_pad), NEG_INF, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    best_i = torch.zeros(B, dtype=i32, device=dev)
    best_j = torch.zeros(B, dtype=i32, device=dev)
    tb = torch.zeros((B, rows_max, w_pad), dtype=torch.uint8, device=dev)
    j_base = dm - off - k_pad - 1  # + i gives the 1-based DP column per lane
    t_base = dm - off - k_pad - 2 + pad  # + i gives the target window index

    n_rows = min(rows_max, int(q_lens.max())) if B else 0
    for i in range(1, n_rows + 1):
        j = j_base + i
        active = i <= l1
        in_cols = j < cols
        filled = active & in_band & (j >= 1) & in_cols
        in_pad = active & in_band_pad & (j >= 0) & in_cols

        # Vertical gap state D from the previous row's dm+1 lanes (unmasked carry).
        d_open = torch.cat([m[:, 1:], neg_col], 1) - goe
        d_ext = torch.cat([d[:, 1:], neg_col], 1) - ge
        d_cur = torch.maximum(d_open, d_ext)
        tb_d_ext = d_open < d_ext  # open wins ties

        q_char = q[:, min(i - 1, rows_max - 1)]
        t_char = torch.gather(t, 1, (t_base + i).clamp(0, T - 1).to(torch.int64))
        diag = m + mat[q_char[:, None] * 256 + t_char]

        h_ng = torch.where(filled, torch.maximum(diag, d_cur), neg)
        border = torch.where(in_pad, zero, neg)
        h_c = torch.where(filled, h_ng.clamp_min(0), border)

        # Horizontal gap state I: exclusive max-plus prefix scan along the band.
        run = torch.cummax(h_c + dm_ge, dim=1).values
        i_cur = torch.where(filled, torch.cat([neg_col, run[:, :-1]], 1) - gap_open - dm_ge, neg)
        m_cur = torch.where(filled, torch.maximum(h_c, i_cur).clamp_min(0), border)

        # Traceback bits in the reference's comparison order.
        best_v = diag
        tb_m = (d_cur > best_v).to(i32)
        best_v = torch.maximum(best_v, d_cur)
        tb_m = torch.where(i_cur > best_v, 2, tb_m)
        best_v = torch.maximum(best_v, i_cur)
        tb_m = torch.where((best_v <= 0) | ~filled, 3, tb_m)
        i_open = torch.cat([neg_col, m_cur[:, :-1]], 1) - goe
        i_ext = torch.cat([neg_col, i_cur[:, :-1]], 1) - ge
        tb[:, i - 1] = (
            tb_m | (tb_d_ext.to(i32) << 2) | ((i_open < i_ext).to(i32) << 3)
        ).to(torch.uint8)

        # Strictly-greater best update; the first lane of the row wins ties.
        masked = torch.where(filled, m_cur, neg)
        row_best = masked.max(dim=1).values
        first = torch.where(masked == row_best[:, None], dm, w_pad).min(dim=1).values
        upd = row_best > best
        best = torch.where(upd, row_best, best)
        best_i = torch.where(upd, i, best_i)
        best_j = torch.where(upd, i - off[:, 0] + first - k_pad - 1, best_j)
        m, d = m_cur, d_cur
    return tb, best, best_i, best_j


def traceback_plain(
    tb: torch.Tensor,
    q_codes: torch.Tensor,
    t_codes: torch.Tensor,
    best: torch.Tensor,
    best_i: torch.Tensor,
    best_j: torch.Tensor,
    offsets: torch.Tensor,
    *,
    rows_max: int,
    w_pad: int,
    t_pad: int,
) -> SwgResult:
    r"""Plain PyTorch traceback (``kaptive_tpu.ops.swg._traceback``), all pairs in lockstep.

    Replays the state machine (0 = in M, 1 = in D, 2 = in I) over the packed
    bits until every pair stops; a pair that has stopped no longer changes.
    """
    count("swg.plain.traceback")
    dev = tb.device
    B, T = q_codes.shape[0], t_codes.shape[1]
    k_pad = (w_pad - 3) // 2
    rows = torch.arange(B, device=dev)
    q = q_codes.to(torch.int64)
    t = t_codes.to(torch.int64)
    off = offsets.to(dev, torch.int64)
    i = best_i.to(torch.int64).clone()
    j = best_j.to(torch.int64).clone()
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    matches = torch.zeros_like(state)
    mism = torch.zeros_like(state)
    gaps = torch.zeros_like(state)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        alive = ~done & (i > 0) & (j > 0)
        if not bool(alive.any()):
            break
        r = (i - 1).clamp(0, rows_max - 1)
        cell = tb[rows, r, (j - (i - off) + k_pad + 1).clamp(0, w_pad - 1)].to(torch.int64)
        tb_m = cell & 3
        tb_d_ext = (cell >> 2) & 1
        tb_i_ext = (cell >> 3) & 1
        is_match = q[rows, r] == t[rows, (j - 1 + t_pad).clamp(0, T - 1)]

        in_m = alive & (state == 0)
        m_stop = in_m & (tb_m == 3)
        m_diag = in_m & (tb_m == 0)
        m_to_d = in_m & (tb_m == 1)
        m_to_i = in_m & (tb_m == 2)
        in_d = alive & (state == 1)
        in_i = alive & (state == 2)

        matches += (m_diag & is_match).to(torch.int64)
        mism += (m_diag & ~is_match).to(torch.int64)
        gaps += (in_d | in_i).to(torch.int64)
        i -= (m_diag | in_d).to(torch.int64)
        j -= (m_diag | in_i).to(torch.int64)
        state = torch.where(
            m_to_d, 1,
            torch.where(
                m_to_i, 2,
                torch.where((in_d & (tb_d_ext == 0)) | (in_i & (tb_i_ext == 0)), 0, state),
            ),
        )
        state = torch.where(m_diag | m_stop, 0, state)
        done |= m_stop
    i32 = torch.int32
    return SwgResult(
        best.to(i32), matches.to(i32), mism.to(i32), gaps.to(i32),
        i.to(i32), best_i.to(i32), j.to(i32), best_j.to(i32),
    )


def banded_swg_plain(
    q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
    *, gap_open: int, gap_extend: int, rows_max: int, w_pad: int, t_pad: int,
) -> SwgResult:
    r"""Plain PyTorch banded SWG: :func:`fill_band_plain` then :func:`traceback_plain`."""
    tb, best, bi, bj = fill_band_plain(
        q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
        gap_open=gap_open, gap_extend=gap_extend, rows_max=rows_max, w_pad=w_pad,
    )
    return traceback_plain(
        tb, q_codes, t_codes, best, bi, bj, offsets,
        rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
    )


def banded_swg(
    q_codes: torch.Tensor,  # (B, rows_max) uint8
    q_lens: torch.Tensor,  # (B,) int32
    t_codes: torch.Tensor,  # (B, T) uint8, padded by exactly t_pad on the left
    t_lens: torch.Tensor,  # (B,) int32
    offsets: torch.Tensor,  # (B,) int32 diagonal offsets
    k_locals: torch.Tensor,  # (B,) int32 half band widths (2*k+3 <= w_pad)
    matrix: torch.Tensor,  # (256, 256) substitution scores
    *,
    gap_open: int,
    gap_extend: int,
    rows_max: int,
    w_pad: int,
    t_pad: int,
) -> SwgResult:
    r"""Banded SWG front door: the Hopper kernels for CUDA tensors, the plain version on the CPU.

    ``t_codes`` must be padded on the left by EXACTLY ``t_pad == w_pad + 2``
    elements: the fill derives its target window base from the band geometry.
    There is no fallback: a CUDA tensor that the kernels cannot take raises.
    """
    if t_pad != w_pad + 2:
        raise ValueError(f"banded SWG requires t_pad == w_pad + 2 (got {t_pad}, {w_pad})")
    if q_codes.is_cuda:
        from kaptive_tpu_torch.ops import swg_cuda

        return swg_cuda.banded_swg_cuda(
            q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
            gap_open=gap_open, gap_extend=gap_extend,
            rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
        )
    if q_codes.device.type != "cpu":
        raise ValueError(f"banded_swg: unsupported device {q_codes.device}")
    return banded_swg_plain(
        q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
        gap_open=gap_open, gap_extend=gap_extend,
        rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
    )
