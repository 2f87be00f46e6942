r"""Batched banded protein/nucleotide aligner on PyTorch (counterpart of ``kaptive_tpu.core.pairwise``).

:class:`PairwiseAligner` keeps the reference's defaults (gap_open=11,
gap_extend=1, band k=20; unseeded band ``max(k, |len1-len2|+1)``, seeded band
``k`` on the seed diagonal) and returns the JAX package's
:class:`~kaptive_tpu.core.pairwise.PairwiseAlignments`.

:func:`batched_swg_align` uploads the two ragged byte streams once, gathers
each bucket's padded (query, target) matrices on the device with torch
indexing, runs :func:`kaptive_tpu_torch.ops.swg.banded_swg` per bucket and
brings every bucket's results back in one device-to-host copy per sweep.
:func:`batched_swg_align_cigars` does the same through
:func:`~kaptive_tpu_torch.ops.swg.banded_swg_cigars` and also returns the
JAX package's :class:`~kaptive_tpu.core.alignment.Cigars`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from kaptive_tpu.core.alignment import Cigars
from kaptive_tpu.core.collections import cumulative_offsets
from kaptive_tpu.core.pairwise import PairwiseAlignments, blosum62_matrix
from kaptive_tpu.core.seq import Sequences

from kaptive_tpu_torch.ops.swg import MAX_CIGAR_OPS, SwgLattice, banded_swg, banded_swg_cigars, plan_swg_buckets
from kaptive_tpu_torch.utils.device import resolve_device

_RESULT_FIELDS = ("scores", "matches", "mismatches", "gaps", "q_starts", "q_ends", "t_starts", "t_ends")


@dataclass(frozen=True, slots=True)
class PairwiseAligner:
    r"""Batched banded Smith-Waterman-Gotoh aligner on ``device`` (CUDA by default)."""

    gap_open: int = 11
    gap_extend: int = 1
    k: int = 20
    lattice: SwgLattice | None = None  # optional frozen bucket-shape set
    device: str | torch.device = "cuda"

    def __call__(self, queries: Sequences, targets: Sequences, seeds: Any | None = None) -> PairwiseAlignments:
        if len(queries.offsets) != len(targets.offsets):
            raise ValueError("Query and target batches must have the same number of sequences.")
        n = len(queries.offsets)
        if n == 0:
            return PairwiseAlignments.empty()

        if seeds is not None:
            offsets_arr = np.asarray(seeds.offsets, dtype=np.int32)
            k_locals = np.full(n, self.k, dtype=np.int32)
        else:
            offsets_arr = np.zeros(n, dtype=np.int32)
            k_locals = np.maximum(
                self.k, np.abs(queries.lengths.astype(np.int64) - targets.lengths.astype(np.int64)) + 1
            ).astype(np.int32)

        return batched_swg_align(
            queries.seqs, queries.offsets, queries.lengths,
            targets.seqs, targets.offsets, targets.lengths,
            offsets_arr, k_locals,
            matrix=np.asarray(blosum62_matrix(), dtype=np.int32),
            gap_open=self.gap_open, gap_extend=self.gap_extend,
            lattice=self.lattice, device=self.device,
        )


def _upload_stream(data: np.ndarray, device: torch.device) -> torch.Tensor:
    # One element at least, so the clamped gather below always has a target.
    data = np.require(data, np.uint8, ["C", "W"]) if len(data) else np.zeros(1, np.uint8)
    return torch.from_numpy(data).to(device)


def _ragged_gather(q_data, t_data, q_off, q_len, t_off, t_len, *, rows_max: int, t_cols: int, t_pad: int):
    r"""One bucket's padded (query, target) uint8 matrices, zero outside each length
    (the ``_ragged_gather_jit`` counterpart)."""
    dev = q_data.device
    j = torch.arange(rows_max, device=dev)[None, :]
    q = q_data[(q_off[:, None] + j).clamp(0, q_data.shape[0] - 1)]
    q = torch.where(j < q_len[:, None], q, 0)
    jt = torch.arange(t_cols, device=dev)[None, :]
    t = t_data[(t_off[:, None] + (jt - t_pad)).clamp(0, t_data.shape[0] - 1)]
    t = torch.where((jt >= t_pad) & (jt < t_pad + t_len[:, None]), t, 0)
    return q.contiguous(), t.contiguous()


def cigars_from_runs(ops: np.ndarray, n_ops: np.ndarray, overflow: np.ndarray) -> Cigars:
    r"""Ragged :class:`Cigars` from per-pair run buffers (n, cap) uint32; a pair
    that overflowed its buffer gets an empty CIGAR."""
    lengths = np.where(overflow, 0, n_ops).astype(np.int32)
    kept = np.arange(ops.shape[1])[None, :] < lengths[:, None]
    return Cigars(ops[kept].astype(np.uint32), cumulative_offsets(lengths), lengths)


def run_bucket(args: tuple, statics: dict, emit_cigars: bool) -> torch.Tensor:
    r"""One padded bucket through :func:`banded_swg` (or, with ``emit_cigars``,
    :func:`banded_swg_cigars`), its outputs stacked as one int32 tensor: the 8
    :class:`SwgResult` rows, then ``n_ops``, ``overflow`` and the (cap, B) runs."""
    if not emit_cigars:
        return torch.stack(tuple(banded_swg(*args, **statics)))
    res, ops, n_ops, overflow = banded_swg_cigars(*args, **statics)
    return torch.cat([torch.stack(tuple(res)), n_ops[None], overflow[None].to(torch.int32), ops.T])


def collect_buckets(n: int, launched: list, emit_cigars: bool) -> tuple[PairwiseAlignments, Cigars | None]:
    r"""Bring :func:`run_bucket` outputs ``[(pair indices, stacked[:, :len(indices)])]``
    back to the host in one copy and put them in pair order:
    ``(PairwiseAlignments, Cigars or None)``."""
    out = {k: np.zeros(n, dtype=np.int32) for k in _RESULT_FIELDS}
    ops = np.zeros((n, MAX_CIGAR_OPS), dtype=np.uint32)
    n_ops = np.zeros(n, dtype=np.int32)
    overflow = np.zeros(n, dtype=bool)
    if launched:
        stacked = torch.cat([part for _, part in launched], dim=1).cpu().numpy()
        order = np.concatenate([sel for sel, _ in launched])
        for i, field in enumerate(_RESULT_FIELDS):
            out[field][order] = stacked[i]
        if emit_cigars:
            n_ops[order] = stacked[8]
            overflow[order] = stacked[9] != 0
            ops[order] = stacked[10:].T.view(np.uint32)
    res = PairwiseAlignments(*(out[f] for f in _RESULT_FIELDS))
    return res, cigars_from_runs(ops, n_ops, overflow) if emit_cigars else None


def _align_buckets(
    q_data, q_offsets, q_lengths, t_data, t_offsets, t_lengths, diag_offsets, k_locals,
    matrix, gap_open: int, gap_extend: int, lattice, device, emit_cigars: bool,
):
    r"""The bucketed sweep of :func:`batched_swg_align` (and, with ``emit_cigars``,
    of :func:`batched_swg_align_cigars`): ``(PairwiseAlignments, Cigars or None)``."""
    device = resolve_device(device)
    if device.type == "cuda":
        from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix

        mat = as_kernel_matrix(matrix, device)
    else:
        mat = torch.from_numpy(np.array(matrix, dtype=np.int32))
    w_needed = 2 * k_locals.astype(np.int64) + 3
    joint = np.maximum(np.maximum(q_lengths, t_lengths), 1)
    q_data_d = _upload_stream(q_data, device)
    t_data_d = _upload_stream(t_data, device)
    launched = []
    for sel, rows_max, w_pad, b_pad in plan_swg_buckets(joint, w_needed, lattice):
        t_pad = w_pad + 2
        meta = np.zeros((6, b_pad), dtype=np.int64)
        meta[4] = 1  # padding pairs: empty, band 1
        for row, src in enumerate((q_offsets, q_lengths, t_offsets, t_lengths, k_locals, diag_offsets)):
            meta[row, : len(sel)] = src[sel]
        q_off, q_len, t_off, t_len, kl, do = torch.from_numpy(meta).to(device).unbind(0)
        q_mat, t_mat = _ragged_gather(
            q_data_d, t_data_d, q_off, q_len, t_off, t_len,
            rows_max=rows_max, t_cols=rows_max + 2 * t_pad, t_pad=t_pad,
        )
        i32 = torch.int32
        args = (q_mat, q_len.to(i32), t_mat, t_len.to(i32), do.to(i32), kl.to(i32), mat)
        statics = dict(gap_open=gap_open, gap_extend=gap_extend, rows_max=rows_max, w_pad=w_pad, t_pad=t_pad)
        launched.append((sel, run_bucket(args, statics, emit_cigars)[:, : len(sel)]))
    return collect_buckets(len(q_offsets), launched, emit_cigars)


def batched_swg_align(
    q_data: np.ndarray, q_offsets: np.ndarray, q_lengths: np.ndarray,
    t_data: np.ndarray, t_offsets: np.ndarray, t_lengths: np.ndarray,
    diag_offsets: np.ndarray, k_locals: np.ndarray,
    matrix: np.ndarray, gap_open: int, gap_extend: int,
    lattice: SwgLattice | None = None, device: str | torch.device = "cuda",
) -> PairwiseAlignments:
    r"""Bucket ragged pairs into padded device batches and run :func:`banded_swg`.

    The two ragged streams are uploaded once and each bucket's matrices are
    gathered on ``device``.  Every bucket is launched before anything is
    copied back; the stacked ``(8, pairs)`` results of all buckets then cross
    to the host in one copy.
    """
    return _align_buckets(
        q_data, q_offsets, q_lengths, t_data, t_offsets, t_lengths, diag_offsets, k_locals,
        matrix, gap_open, gap_extend, lattice, device, emit_cigars=False,
    )[0]


def batched_swg_align_cigars(
    q_data: np.ndarray, q_offsets: np.ndarray, q_lengths: np.ndarray,
    t_data: np.ndarray, t_offsets: np.ndarray, t_lengths: np.ndarray,
    diag_offsets: np.ndarray, k_locals: np.ndarray,
    matrix: np.ndarray, gap_open: int, gap_extend: int,
    lattice: SwgLattice | None = None, device: str | torch.device = "cuda",
) -> tuple[PairwiseAlignments, Cigars]:
    r"""Like :func:`batched_swg_align` but with BAM CIGARs from the traceback
    (:func:`~kaptive_tpu_torch.ops.swg.banded_swg_cigars`).

    Returns ``(PairwiseAlignments, Cigars)``; a pair whose run count
    overflowed its ``MAX_CIGAR_OPS`` buffer gets an empty CIGAR (its
    statistics stay exact).  Buckets follow :func:`plan_swg_buckets` as in
    count-only mode; a pair's result does not depend on its bucket.
    """
    return _align_buckets(
        q_data, q_offsets, q_lengths, t_data, t_offsets, t_lengths, diag_offsets, k_locals,
        matrix, gap_open, gap_extend, lattice, device, emit_cigars=True,
    )
