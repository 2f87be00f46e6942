r"""ctypes binding of the Hopper banded-SWG kernels (``csrc/swg.cu``).

Replaces ``kaptive_tpu/ops/swg_pallas.py::_swg_fill_kernel`` (the band fill),
``kaptive_tpu/ops/swg.py::_traceback`` (the walk back from the best cell) and
``kaptive_tpu/ops/swg.py::_traceback_cigar`` (the same walk recording BAM
CIGAR runs).  The library is compiled at first use (:mod:`kaptive_tpu_torch.utils.nvcc`,
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/kaptive_tpu_torch/``
at the root of the checkout) and loaded with ctypes; nothing is compiled at
import.

The fill has four forms and picks one from ``w_pad`` and the matrix's dtype
(:func:`fill_form`).  With an int8 matrix (every score in int8, as
:func:`as_kernel_matrix` gives it for BLOSUM62 and the mapper's 2/-4): the
warp form (one warp per pair, the band in registers) for the widths the
lattices produce, a multiple of 128 up to 1024, and the wide form (one block
per pair, the band in shared memory) for every other width up to
``kts_swg_max_w_pad()`` (8,192).  Every wider band the planner emits up to
131,072 lanes, and every band with an int32 matrix (a score outside int8),
takes the cluster form: int32 scores, the band in registers, one warp a pair
up to 512 lanes, else a thread-block cluster of up to 16 CTAs a pair that
share the scan's totals and their edge lanes through distributed shared
memory (:func:`cluster_plan`).  Past the largest cluster (the planner's
524,288) the segmented form: one block per pair walks each row's band in
segments of 8,192 lanes staged in shared memory, with the M and D bands in
device scratch between rows.  Both tracebacks are instances of one walk: one warp
per pair reads up to 32 cells of the current diagonal, column or row at once.
The CIGAR instance also records the runs, staged in shared memory, and the
warp writes each pair's row of ``ops`` once, reversed into alignment order and
zero-filled.

Each wrapper checks device, dtype, shape and contiguity, allocates its outputs
with ``torch.empty``, launches on the calling thread's current stream, raises
if the launch returns a CUDA error, and counts its launches
(``swg.cuda.fill`` / ``swg.cuda.fill_cluster`` / ``swg.cuda.fill_segmented`` /
``swg.cuda.traceback`` /
``swg.cuda.traceback_cigar`` in :mod:`kaptive_tpu_torch.utils.metrics`).
There is no fallback: what the kernels cannot take raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kaptive_tpu_torch.ops.swg import MAX_CIGAR_OPS, SwgResult
from kaptive_tpu_torch.utils.metrics import count
from kaptive_tpu_torch.utils.nvcc import CudaLibrary, check_tensor


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kts_swg_max_w_pad.restype = i32
    lib.kts_swg_max_w_pad.argtypes = []
    lib.kts_swg_fill_warp_form.restype = i32
    lib.kts_swg_fill_warp_form.argtypes = [i32]
    lib.kts_swg_fill.restype = i32
    lib.kts_swg_fill.argtypes = [ptr] * 7 + [i32] * 6 + [ptr] * 5
    lib.kts_swg_fill_segmented.restype = i32
    lib.kts_swg_fill_segmented.argtypes = [ptr] * 7 + [i32] * 6 + [ptr] * 6
    lib.kts_swg_fill_cluster_plan.restype = i32
    lib.kts_swg_fill_cluster_plan.argtypes = [i32, ctypes.POINTER(i32)]
    lib.kts_swg_fill_cluster.restype = i32
    lib.kts_swg_fill_cluster.argtypes = [ptr] * 7 + [i32] * 6 + [ptr] * 5
    lib.kts_swg_traceback.restype = i32
    lib.kts_swg_traceback.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 2
    lib.kts_swg_traceback_cigar.restype = i32
    lib.kts_swg_traceback_cigar.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 5


LIBRARY = CudaLibrary("swg.cu", _declare)


def build() -> ctypes.CDLL:
    r"""Compile (when the source is newer than the library) and load the kernels."""
    return LIBRARY.load()


def cluster_plan(w_pad: int) -> tuple[int, int, int, int] | None:
    r"""The cluster form's geometry for ``w_pad`` on the current device: ``(ctas, slice, lanes a
    thread, threads a CTA)``, ``ctas`` 0 for one warp a pair.  None when the cluster form does not
    take the band."""
    out = (ctypes.c_int * 4)()
    return tuple(out) if build().kts_swg_fill_cluster_plan(int(w_pad), out) else None


def fill_form(w_pad: int, dtype: torch.dtype = torch.int8) -> str:
    r"""The form of the fill kernel that takes ``w_pad`` with a matrix of ``dtype``:
    ``"warp"``, ``"wide"``, ``"cluster"`` or ``"segmented"``."""
    lib = build()
    if dtype == torch.int8 and w_pad <= lib.kts_swg_max_w_pad():
        return "warp" if lib.kts_swg_fill_warp_form(int(w_pad)) else "wide"
    return "cluster" if cluster_plan(w_pad) is not None else "segmented"


def swg_fill_cuda(
    q_codes: torch.Tensor,  # (B, rows_max) uint8
    q_lens: torch.Tensor,  # (B,) int32
    t_codes: torch.Tensor,  # (B, T) uint8, left-padded by w_pad + 2
    t_lens: torch.Tensor,  # (B,) int32
    offsets: torch.Tensor,  # (B,) int32
    k_locals: torch.Tensor,  # (B,) int32
    matrix: torch.Tensor,  # (256, 256) int8 or int32
    *,
    gap_open: int,
    gap_extend: int,
    rows_max: int,
    w_pad: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Band fill on the card: ``(tb, best, best_i, best_j)`` as :func:`fill_band_plain`.

    ``matrix`` is int8 (the warp and wide forms up to ``w_pad`` 8,192) or int32
    (the cluster and segmented forms, which also take an int8 matrix's wider bands).
    Rows of ``tb`` at or past each pair's query length are left unwritten.
    """
    device = q_codes.device
    if device.type != "cuda":
        raise ValueError(f"swg_fill_cuda expects CUDA tensors, got {device}")
    lib = build()
    B = q_codes.shape[0]
    T = t_codes.shape[1] if t_codes.dim() == 2 else -1
    check_tensor("q_codes", q_codes, torch.uint8, (B, rows_max), device)
    check_tensor("t_codes", t_codes, torch.uint8, (B, T), device)
    for name, x in (("q_lens", q_lens), ("t_lens", t_lens), ("offsets", offsets), ("k_locals", k_locals)):
        check_tensor(name, x, torch.int32, (B,), device)
    check_tensor("matrix", matrix, matrix.dtype if matrix.dtype == torch.int32 else torch.int8, (256, 256), device)
    if matrix.data_ptr() % 16:
        raise ValueError("matrix: expected a 16-byte aligned tensor")
    if w_pad < 3:
        raise ValueError(f"w_pad={w_pad}: a band needs at least 3 lanes (w_pad = 2 k_pad + 3)")
    if rows_max < 1 or T < 1:
        raise ValueError(f"empty bucket geometry (rows_max={rows_max}, T={T})")

    tb = torch.empty((B, rows_max, w_pad), dtype=torch.uint8, device=device)
    best = torch.empty(B, dtype=torch.int32, device=device)
    best_i = torch.empty(B, dtype=torch.int32, device=device)
    best_j = torch.empty(B, dtype=torch.int32, device=device)
    with torch.cuda.device(device):  # the launch goes to the current device, and the plan is its own
        form = fill_form(w_pad, matrix.dtype)
        stream = torch.cuda.current_stream(device).cuda_stream
        if form == "cluster":
            scores = matrix.to(torch.int32).contiguous()
            rc = lib.kts_swg_fill_cluster(
                q_codes.data_ptr(), t_codes.data_ptr(), q_lens.data_ptr(), t_lens.data_ptr(),
                offsets.data_ptr(), k_locals.data_ptr(), scores.data_ptr(),
                B, rows_max, w_pad, T, int(gap_open), int(gap_extend),
                tb.data_ptr(), best.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), stream,
            )
        elif form == "segmented":
            scores = matrix.to(torch.int32).contiguous()
            scratch = torch.empty((B, 2, w_pad), dtype=torch.int32, device=device)  # the M and D bands
            rc = lib.kts_swg_fill_segmented(
                q_codes.data_ptr(), t_codes.data_ptr(), q_lens.data_ptr(), t_lens.data_ptr(),
                offsets.data_ptr(), k_locals.data_ptr(), scores.data_ptr(),
                B, rows_max, w_pad, T, int(gap_open), int(gap_extend), scratch.data_ptr(),
                tb.data_ptr(), best.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), stream,
            )
        else:
            rc = lib.kts_swg_fill(
                q_codes.data_ptr(), t_codes.data_ptr(), q_lens.data_ptr(), t_lens.data_ptr(),
                offsets.data_ptr(), k_locals.data_ptr(), matrix.data_ptr(),
                B, rows_max, w_pad, T, int(gap_open), int(gap_extend),
                tb.data_ptr(), best.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), stream,
            )
    if rc != 0:
        raise RuntimeError(f"swg fill kernel launch failed ({form} form, w_pad={w_pad}): CUDA error {rc}")
    count({"cluster": "swg.cuda.fill_cluster", "segmented": "swg.cuda.fill_segmented"}.get(form, "swg.cuda.fill"))
    return tb, best, best_i, best_j


def swg_traceback_cuda(
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
) -> torch.Tensor:
    r"""Traceback on the card: an (8, B) int32 tensor in :class:`SwgResult` field order."""
    device = tb.device
    if device.type != "cuda":
        raise ValueError(f"swg_traceback_cuda expects CUDA tensors, got {device}")
    lib = build()
    B = q_codes.shape[0]
    T = t_codes.shape[1] if t_codes.dim() == 2 else -1
    check_tensor("tb", tb, torch.uint8, (B, rows_max, w_pad), device)
    check_tensor("q_codes", q_codes, torch.uint8, (B, rows_max), device)
    check_tensor("t_codes", t_codes, torch.uint8, (B, T), device)
    for name, x in (("best", best), ("best_i", best_i), ("best_j", best_j), ("offsets", offsets)):
        check_tensor(name, x, torch.int32, (B,), device)
    out = torch.empty((8, B), dtype=torch.int32, device=device)
    with torch.cuda.device(device):  # the launch goes to the current device
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.kts_swg_traceback(
            tb.data_ptr(), q_codes.data_ptr(), t_codes.data_ptr(), best.data_ptr(),
            best_i.data_ptr(), best_j.data_ptr(), offsets.data_ptr(),
            B, rows_max, w_pad, T, int(t_pad), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"swg traceback kernel launch failed: CUDA error {rc}")
    count("swg.cuda.traceback")
    return out


def swg_traceback_cigar_cuda(
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""CIGAR traceback on the card: ``(out, ops, n_ops, overflow)``.

    ``out`` is (8, B) int32 in :class:`SwgResult` field order; ``ops``,
    ``n_ops`` and ``overflow`` are :func:`~kaptive_tpu_torch.ops.swg.traceback_cigar_plain`'s.
    """
    device = tb.device
    if device.type != "cuda":
        raise ValueError(f"swg_traceback_cigar_cuda expects CUDA tensors, got {device}")
    lib = build()
    B = q_codes.shape[0]
    T = t_codes.shape[1] if t_codes.dim() == 2 else -1
    check_tensor("tb", tb, torch.uint8, (B, rows_max, w_pad), device)
    check_tensor("q_codes", q_codes, torch.uint8, (B, rows_max), device)
    check_tensor("t_codes", t_codes, torch.uint8, (B, T), device)
    for name, x in (("best", best), ("best_i", best_i), ("best_j", best_j), ("offsets", offsets)):
        check_tensor(name, x, torch.int32, (B,), device)
    out = torch.empty((8, B), dtype=torch.int32, device=device)
    ops = torch.empty((B, MAX_CIGAR_OPS), dtype=torch.int32, device=device)
    n_ops = torch.empty(B, dtype=torch.int32, device=device)
    overflow = torch.empty(B, dtype=torch.bool, device=device)
    with torch.cuda.device(device):  # the launch goes to the current device
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.kts_swg_traceback_cigar(
            tb.data_ptr(), q_codes.data_ptr(), t_codes.data_ptr(), best.data_ptr(),
            best_i.data_ptr(), best_j.data_ptr(), offsets.data_ptr(),
            B, rows_max, w_pad, T, int(t_pad),
            out.data_ptr(), ops.data_ptr(), n_ops.data_ptr(), overflow.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"swg CIGAR traceback kernel launch failed: CUDA error {rc}")
    count("swg.cuda.traceback_cigar")
    return out, ops, n_ops, overflow


def as_kernel_matrix(matrix: torch.Tensor | object, device: torch.device) -> torch.Tensor:
    r"""A (256, 256) substitution matrix as the fill takes it: a contiguous tensor on ``device``,
    int8 when every score fits in int8 (the warp and wide forms keep it in shared memory),
    else int32 (the cluster and segmented forms read it from device memory), as the JAX package casts it."""
    m = matrix if isinstance(matrix, torch.Tensor) else torch.from_numpy(np.array(matrix))
    if m.dtype != torch.int8:
        fits = int(m.min()) >= -128 and int(m.max()) <= 127
        m = m.to(torch.int8 if fits else torch.int32)
    return m.to(device).contiguous()


def banded_swg_cuda(
    q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
    *, gap_open: int, gap_extend: int, rows_max: int, w_pad: int, t_pad: int,
) -> SwgResult:
    r"""Fill + traceback on the card; the same :class:`SwgResult` as the plain version."""
    if t_pad != w_pad + 2:
        raise ValueError(f"banded SWG requires t_pad == w_pad + 2 (got {t_pad}, {w_pad})")
    matrix = as_kernel_matrix(matrix, q_codes.device)
    tb, best, best_i, best_j = swg_fill_cuda(
        q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
        gap_open=gap_open, gap_extend=gap_extend, rows_max=rows_max, w_pad=w_pad,
    )
    out = swg_traceback_cuda(
        tb, q_codes, t_codes, best, best_i, best_j, offsets,
        rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
    )
    return SwgResult(*out.unbind(0))


def banded_swg_cigars_cuda(
    q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
    *, gap_open: int, gap_extend: int, rows_max: int, w_pad: int, t_pad: int,
):
    r"""Fill + CIGAR traceback on the card: ``(SwgResult, ops, n_ops, overflow)`` as the plain version."""
    if t_pad != w_pad + 2:
        raise ValueError(f"banded SWG requires t_pad == w_pad + 2 (got {t_pad}, {w_pad})")
    matrix = as_kernel_matrix(matrix, q_codes.device)
    tb, best, best_i, best_j = swg_fill_cuda(
        q_codes, q_lens, t_codes, t_lens, offsets, k_locals, matrix,
        gap_open=gap_open, gap_extend=gap_extend, rows_max=rows_max, w_pad=w_pad,
    )
    out, ops, n_ops, overflow = swg_traceback_cigar_cuda(
        tb, q_codes, t_codes, best, best_i, best_j, offsets,
        rows_max=rows_max, w_pad=w_pad, t_pad=t_pad,
    )
    return SwgResult(*out.unbind(0)), ops, n_ops, overflow
