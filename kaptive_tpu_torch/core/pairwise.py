r"""Pairwise alignment containers and the batched banded protein/nucleotide aligner on PyTorch.

:class:`PairwiseAlignment` / :class:`PairwiseAlignments` hold the results and
:func:`blosum62_matrix` is the 256x256 byte-indexed BLOSUM62 (standard public
values).  :class:`PairwiseAligner` keeps upstream Kaptive's defaults
(gap_open=11, gap_extend=1, band k=20; unseeded band ``max(k, |len1-len2|+1)``,
seeded band ``k`` on the seed diagonal).

:func:`launch_sweep` is the port's one bucketed banded-SWG sweep, which the
protein aligner and the mapper's extension DP (on one device or cut over a
mesh) share: each bucket's padded (query, target) matrices are gathered on the
device from two byte streams (:func:`gather_bucket`), each bucket runs
:func:`kaptive_tpu_torch.ops.swg.banded_swg` (:func:`run_bucket`) and
:func:`collect_buckets` brings every bucket's results back in one
device-to-host copy per sweep.  Each sweep is two spans: ``dp.launch``
(uploads, bucket plan, gathers, launches; it counts ``dp.cells_live`` and
``dp.cells_launched``) and ``dp.collect`` (the copy back, where the host waits
for the card).  :func:`batched_swg_align` runs it on two ragged byte streams;
:func:`batched_swg_align_cigars` does the same through
:func:`~kaptive_tpu_torch.ops.swg.banded_swg_cigars` and also returns
:class:`~kaptive_tpu_torch.core.alignment.Cigars`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cache
from typing import Any, NamedTuple

import numpy as np
import numpy.typing as npt
import torch

from kaptive_tpu_torch.core.alignment import Cigars
from kaptive_tpu_torch.core.collections import SoAContainer, cumulative_offsets, soa
from kaptive_tpu_torch.core.seq import Sequences
from kaptive_tpu_torch.ops.swg import (
    MAX_CIGAR_OPS,
    SwgLattice,
    banded_swg,
    banded_swg_cigars,
    device_matrix,
    plan_swg_buckets,
    sharded_banded_swg,
)
from kaptive_tpu_torch.utils.device import device_count, resolve_device, sharded
from kaptive_tpu_torch.utils.profiling import phase_timer

_RESULT_FIELDS = ("scores", "matches", "mismatches", "gaps", "q_starts", "q_ends", "t_starts", "t_ends")


@dataclass(frozen=True, slots=True)
class PairwiseAlignment:
    r"""Summary statistics and coordinates for one pairwise alignment."""

    score: int
    matches: int
    mismatches: int
    gaps: int
    q_start: int
    q_end: int
    t_start: int
    t_end: int

    @property
    def pident(self) -> float:
        total = self.matches + self.mismatches + self.gaps
        return (self.matches / total) * 100.0 if total > 0 else 0.0


@dataclass(frozen=True, slots=True)
class PairwiseAlignments(SoAContainer):
    r"""SoA batch of pairwise alignment results.

    Batch protocol derived by :class:`~kaptive_tpu_torch.core.collections.SoAContainer`;
    integer indexing yields a scalar :class:`PairwiseAlignment` view.
    """

    scores: npt.NDArray[np.int32] = soa(np.int32)
    matches: npt.NDArray[np.int32] = soa(np.int32)
    mismatches: npt.NDArray[np.int32] = soa(np.int32)
    gaps: npt.NDArray[np.int32] = soa(np.int32)
    q_starts: npt.NDArray[np.int32] = soa(np.int32)
    q_ends: npt.NDArray[np.int32] = soa(np.int32)
    t_starts: npt.NDArray[np.int32] = soa(np.int32)
    t_ends: npt.NDArray[np.int32] = soa(np.int32)

    def __getitem__(self, item: Any) -> PairwiseAlignment | PairwiseAlignments:
        if isinstance(item, (int, np.integer)):
            if item < 0:
                item += len(self)
            if item < 0 or item >= len(self):
                raise IndexError("Batch index out of range")
            return PairwiseAlignment(
                *(int(getattr(self, name)[item]) for name, _, _ in self._soa_spec()[0])
            )
        # Explicit base call: slots=True dataclasses recreate the class, which
        # breaks zero-argument super() inside method bodies.
        return SoAContainer.__getitem__(self, item)

    @property
    def pidents(self) -> npt.NDArray[np.float64]:
        total = self.matches + self.mismatches + self.gaps
        return np.divide(self.matches * 100.0, total, out=np.zeros(len(self), dtype=np.float64), where=total > 0)


@cache
def blosum62_matrix(fill_value: int = -128) -> npt.NDArray[np.int8]:
    r"""256x256 byte-indexed BLOSUM62 substitution matrix (standard public values)."""
    # Standard BLOSUM62 over the NCBI alphabet ARNDCQEGHILKMFPSTWYVBJZX* .
    blosum62 = np.array(
        [
            [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0, -2, -1, -1, -1, -4],
            [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3, -1, -2, 0, -1, -4],
            [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3, 4, -3, 0, -1, -4],
            [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3, 4, -3, 1, -1, -4],
            [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1, -3, -1, -3, -1, -4],
            [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2, 0, -2, 4, -1, -4],
            [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2, 1, -3, 4, -1, -4],
            [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3, -1, -4, -2, -1, -4],
            [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3, 0, -3, 0, -1, -4],
            [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3, -3, 3, -3, -1, -4],
            [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1, -4, 3, -3, -1, -4],
            [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2, 0, -3, 1, -1, -4],
            [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1, -3, 2, -1, -1, -4],
            [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1, -3, 0, -3, -1, -4],
            [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2, -2, -3, -1, -1, -4],
            [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2, 0, -2, 0, -1, -4],
            [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0, -1, -1, -1, -1, -4],
            [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3, -4, -2, -2, -1, -4],
            [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1, -3, -1, -2, -1, -4],
            [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4, -3, 2, -2, -1, -4],
            [-2, -1, 4, 4, -3, 0, 1, -1, 0, -3, -4, 0, -3, -3, -2, 0, -1, -4, -3, -3, 4, -3, 0, -1, -4],
            [-1, -2, -3, -3, -1, -2, -3, -4, -3, 3, 3, -3, 2, 0, -3, -2, -1, -2, -1, 2, -3, 3, -3, -1, -4],
            [-1, 0, 0, 1, -3, 4, 4, -2, 0, -3, -3, 1, -1, -3, -1, 0, -1, -2, -2, -2, 0, -3, 4, -1, -4],
            [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -4],
            [-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4, 1],
        ],
        dtype=np.int8,
    )
    alphabet = list(b"ARNDCQEGHILKMFPSTWYVBJZX*")
    score_matrix = np.full((256, 256), fill_value, dtype=np.int8)
    for a, i in enumerate(alphabet):
        for b, j in enumerate(alphabet):
            score_matrix[i, j] = blosum62[a, b]
    score_matrix.flags.writeable = False
    return score_matrix


@dataclass(frozen=True, slots=True)
class PairwiseAligner:
    r"""Batched banded Smith-Waterman-Gotoh aligner on ``device`` (CUDA by default)."""

    gap_open: int = 11
    gap_extend: int = 1
    k: int = 20
    mesh: Any = None  # optional parallel.mesh.Mesh: cuts each bucket's pair axis over its slots
    lattice: SwgLattice | None = None  # optional frozen bucket-shape set
    device: str | torch.device = field(default="cuda", kw_only=True)

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
            lattice=self.lattice, device=self.device, mesh=self.mesh,
        )

    def align_seeds(self, queries: Sequences, targets: Sequences, seeds: Any) -> PairwiseAlignments:
        paired_queries, paired_targets = seeds.extract_sequences(queries, targets)
        return self(paired_queries, paired_targets, seeds)


def _upload_stream(data: np.ndarray, device: torch.device) -> torch.Tensor:
    # One element at least, so the clamped gather below always has a target.
    data = np.require(data, np.uint8, ["C", "W"]) if len(data) else np.zeros(1, np.uint8)
    return torch.from_numpy(data).to(device)


class DpPairs(NamedTuple):
    r"""A sweep's pairs, one int column each (the rows of a bucket's meta block): the
    query's start in its stream, its length and strand (``-1``: read reverse-complemented),
    the target window's start in its stream and length, the band's diagonal offset
    (``q_pos - t_pos``) and half width."""

    q_start: np.ndarray
    q_len: np.ndarray
    strand: np.ndarray
    t_start: np.ndarray
    t_len: np.ndarray
    offsets: np.ndarray
    k_locals: np.ndarray


def gather_bucket(q_stream, t_stream, q_start, q_len, strand, t_start, t_len,
                  *, rows_max: int, t_cols: int, t_pad: int):
    r"""One DP bucket's padded (query, target) uint8 matrices, gathered on the device.

    Queries whose ``strand`` is negative are read backwards and complemented (codes
    below 4); with ``strand`` None every query is on the plus strand, and the
    strand's ops are not issued.  Entries past each length are 0, and the target is
    left-padded by ``t_pad``.
    """
    dev = t_stream.device
    j = torch.arange(rows_max, device=dev)[None, :]
    if strand is None:
        q = q_stream[(q_start[:, None] + j).clamp(0, q_stream.shape[0] - 1)]
    else:
        fwd = (strand > 0)[:, None]
        qi = torch.where(fwd, q_start[:, None] + j, q_start[:, None] + q_len[:, None] - 1 - j)
        q = q_stream[qi.clamp(0, q_stream.shape[0] - 1)]
        q = torch.where(fwd | (q >= 4), q, 3 - q)
    q = torch.where(j < q_len[:, None], q, 0)
    jt = torch.arange(t_cols, device=dev)[None, :]
    t = t_stream[(t_start[:, None] + (jt - t_pad)).clamp(0, t_stream.shape[0] - 1)]
    t = torch.where((jt >= t_pad) & (jt < t_pad + t_len[:, None]), t, 0)
    return q.contiguous(), t.contiguous()


def cigars_from_runs(ops: np.ndarray, n_ops: np.ndarray, overflow: np.ndarray) -> Cigars:
    r"""Ragged :class:`Cigars` from per-pair run buffers (n, cap) uint32; a pair
    that overflowed its buffer gets an empty CIGAR."""
    lengths = np.where(overflow, 0, n_ops).astype(np.int32)
    kept = np.arange(ops.shape[1])[None, :] < lengths[:, None]
    return Cigars(ops[kept].astype(np.uint32), cumulative_offsets(lengths), lengths)


def run_bucket(args: tuple, statics: dict, emit_cigars: bool, mesh=None) -> torch.Tensor:
    r"""One padded bucket through :func:`banded_swg` (or, with ``emit_cigars``,
    :func:`banded_swg_cigars`), its outputs stacked as one int32 tensor: the 8
    :class:`SwgResult` rows, then ``n_ops``, ``overflow`` and the (cap, B) runs.
    With a ``mesh`` (count-only) the pairs are cut over its slots
    (:func:`~kaptive_tpu_torch.ops.swg.sharded_banded_swg`)."""
    if mesh is not None and not emit_cigars:
        return torch.stack(tuple(sharded_banded_swg(mesh, *args, **statics)))
    if not emit_cigars:
        return torch.stack(tuple(banded_swg(*args, **statics)))
    res, ops, n_ops, overflow = banded_swg_cigars(*args, **statics)
    return torch.cat([torch.stack(tuple(res)), n_ops[None], overflow[None].to(torch.int32), ops.T])


def count_cells(span, rows: np.ndarray, k_locals: np.ndarray, plan: list) -> None:
    r"""Add to ``span`` the band cells a sweep's pairs need, ``rows x (2k+3)`` summed
    (``dp.cells_live``), and the cells its ``plan`` launches, ``b_pad x rows_max x w_pad``
    summed over the buckets, padding pairs included (``dp.cells_launched``)."""
    span.add("dp.cells_live", int(np.dot(rows.astype(np.int64), 2 * k_locals.astype(np.int64) + 3)))
    span.add("dp.cells_launched", sum(b_pad * rows_max * w_pad for _, rows_max, w_pad, b_pad in plan))


def collect_buckets(n: int, launched: list, emit_cigars: bool) -> tuple[PairwiseAlignments, Cigars | None]:
    r"""Bring :func:`run_bucket` outputs ``[(pair indices, stacked[:, :len(indices)])]``
    back to the host in one copy and put them in pair order:
    ``(PairwiseAlignments, Cigars or None)``."""
    with phase_timer("dp.collect"):
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


def launch_sweep(
    q_stream, t_stream, pairs: DpPairs, *, matrix, gap_open: int, gap_extend: int,
    lattice: SwgLattice | None, emit_cigars: bool, device: str | torch.device, mesh=None,
):
    r"""Launch one bucketed banded-SWG sweep: every DP of the port runs through here.

    ``q_stream`` and ``t_stream`` are the byte streams the ``pairs`` index, each a
    tensor already on ``device`` or a numpy array uploaded here.  Buckets follow
    :func:`plan_swg_buckets` with ``lattice``; each bucket's columns go up in one
    meta block, its matrices are gathered on ``device`` (:func:`gather_bucket`) and
    it runs through :func:`run_bucket`.  Padding pairs are (start 0, length 1, plus
    strand, band 1, empty target).  With a ``mesh`` of ``n`` slots (count-only) every
    bucket's batch is a multiple of ``n`` (``min_batch = ceil(16 / n) * n``, as in the
    JAX package) and its pairs are cut over the slots.  Returns the pending
    ``(n, [(pair indices, stacked results)], emit_cigars)`` for
    :func:`collect_buckets`; nothing is copied back here.
    """
    with phase_timer("dp.launch") as span:
        device = resolve_device(device)
        mat = device_matrix(matrix, device)
        mesh = mesh if sharded(mesh) and not emit_cigars else None
        n_dev = device_count(mesh)
        q_stream, t_stream = (
            s if isinstance(s, torch.Tensor) else _upload_stream(s, device) for s in (q_stream, t_stream)
        )
        joint = np.maximum(np.maximum(pairs.q_len, pairs.t_len), 1)
        w_needed = 2 * pairs.k_locals.astype(np.int64) + 3
        plan = plan_swg_buckets(joint, w_needed, lattice, min_batch=-(-16 // n_dev) * n_dev)
        if span:
            count_cells(span, pairs.q_len, pairs.k_locals, plan)
        launched = []
        for sel, rows_max, w_pad, b_pad in plan:
            t_pad = w_pad + 2
            meta = np.zeros((len(pairs), b_pad), dtype=np.int64)
            meta[[1, 2, 6]] = 1  # padding pairs: length 1, plus strand, band 1
            for row, col in enumerate(pairs):
                meta[row, : len(sel)] = col[sel]
            q_start, q_len, strand, t_start, t_len, offsets, k_locals = torch.from_numpy(meta).to(device).unbind(0)
            minus = bool((pairs.strand[sel] < 0).any())  # False in every protein bucket
            q_mat, t_mat = gather_bucket(
                q_stream, t_stream, q_start, q_len, strand if minus else None, t_start, t_len,
                rows_max=rows_max, t_cols=rows_max + 2 * t_pad, t_pad=t_pad,
            )
            i32 = torch.int32
            args = (q_mat, q_len.to(i32), t_mat, t_len.to(i32), offsets.to(i32), k_locals.to(i32), mat)
            statics = dict(gap_open=gap_open, gap_extend=gap_extend, rows_max=rows_max, w_pad=w_pad, t_pad=t_pad)
            launched.append((sel, run_bucket(args, statics, emit_cigars, mesh)[:, : len(sel)]))
    return len(pairs.q_len), launched, emit_cigars


def _ragged_pairs(q_offsets, q_lengths, t_offsets, t_lengths, diag_offsets, k_locals) -> DpPairs:
    r"""The plus-strand :class:`DpPairs` of two ragged streams' pairs."""
    return DpPairs(q_offsets, q_lengths, np.ones(len(q_offsets), np.int64), t_offsets, t_lengths,
                   diag_offsets, k_locals)


def batched_swg_align(
    q_data: np.ndarray, q_offsets: np.ndarray, q_lengths: np.ndarray,
    t_data: np.ndarray, t_offsets: np.ndarray, t_lengths: np.ndarray,
    diag_offsets: np.ndarray, k_locals: np.ndarray,
    matrix: np.ndarray, gap_open: int, gap_extend: int,
    mesh=None, lattice: SwgLattice | None = None, *, device: str | torch.device = "cuda",
) -> PairwiseAlignments:
    r"""Bucket ragged pairs into padded device batches and run :func:`banded_swg`.

    The two ragged streams are uploaded once and each bucket's matrices are
    gathered on ``device``; with a ``mesh`` each bucket's pairs are cut over
    its slots.  Every bucket is launched before anything is copied back; the
    stacked ``(8, pairs)`` results of all buckets then cross to the host in
    one copy.
    """
    pairs = _ragged_pairs(q_offsets, q_lengths, t_offsets, t_lengths, diag_offsets, k_locals)
    return collect_buckets(*launch_sweep(
        q_data, t_data, pairs, matrix=matrix, gap_open=gap_open, gap_extend=gap_extend,
        lattice=lattice, emit_cigars=False, device=device, mesh=mesh,
    ))[0]


def batched_swg_align_cigars(
    q_data: np.ndarray, q_offsets: np.ndarray, q_lengths: np.ndarray,
    t_data: np.ndarray, t_offsets: np.ndarray, t_lengths: np.ndarray,
    diag_offsets: np.ndarray, k_locals: np.ndarray,
    matrix: np.ndarray, gap_open: int, gap_extend: int,
    *, lattice: SwgLattice | None = None, device: str | torch.device = "cuda",
) -> tuple[PairwiseAlignments, Cigars]:
    r"""Like :func:`batched_swg_align` but with BAM CIGARs from the traceback
    (:func:`~kaptive_tpu_torch.ops.swg.banded_swg_cigars`).

    Returns ``(PairwiseAlignments, Cigars)``; a pair whose run count
    overflowed its ``MAX_CIGAR_OPS`` buffer gets an empty CIGAR (its
    statistics stay exact).  Buckets follow :func:`plan_swg_buckets` as in
    count-only mode; a pair's result does not depend on its bucket.
    """
    pairs = _ragged_pairs(q_offsets, q_lengths, t_offsets, t_lengths, diag_offsets, k_locals)
    return collect_buckets(*launch_sweep(
        q_data, t_data, pairs, matrix=matrix, gap_open=gap_open, gap_extend=gap_extend,
        lattice=lattice, emit_cigars=True, device=device,
    ))
