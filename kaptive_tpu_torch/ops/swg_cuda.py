r"""ctypes binding of the Hopper banded-SWG kernels (``csrc/swg.cu``).

Replaces ``kaptive_tpu/ops/swg_pallas.py::_swg_fill_kernel`` (the band fill),
``kaptive_tpu/ops/swg.py::_traceback`` (the walk back from the best cell) and
``kaptive_tpu/ops/swg.py::_traceback_cigar`` (the same walk recording BAM
CIGAR runs).  The library is compiled at first use (:mod:`kaptive_tpu_torch.utils.nvcc`,
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/kaptive_tpu_torch/``
at the root of the checkout) and loaded with ctypes; nothing is compiled at
import.

Each wrapper checks device, dtype, shape and contiguity, allocates its outputs
with ``torch.empty``, launches on the calling thread's current stream, raises
if the launch returns a CUDA error, and counts its launches
(``swg.cuda.fill`` / ``swg.cuda.traceback`` / ``swg.cuda.traceback_cigar`` in
:mod:`kaptive_tpu.utils.metrics`).
There is no fallback: what the kernels cannot take raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kaptive_tpu.utils.metrics import count

from kaptive_tpu_torch.ops.swg import MAX_CIGAR_OPS, SwgResult
from kaptive_tpu_torch.utils.nvcc import CudaLibrary, check_tensor


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kts_swg_max_w_pad.restype = i32
    lib.kts_swg_max_w_pad.argtypes = []
    lib.kts_swg_fill.restype = i32
    lib.kts_swg_fill.argtypes = [ptr] * 7 + [i32] * 6 + [ptr] * 5
    lib.kts_swg_traceback.restype = i32
    lib.kts_swg_traceback.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 2
    lib.kts_swg_traceback_cigar.restype = i32
    lib.kts_swg_traceback_cigar.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 5


LIBRARY = CudaLibrary("swg.cu", _declare)


def build() -> ctypes.CDLL:
    r"""Compile (when the source is newer than the library) and load the kernels."""
    return LIBRARY.load()


def swg_fill_cuda(
    q_codes: torch.Tensor,  # (B, rows_max) uint8
    q_lens: torch.Tensor,  # (B,) int32
    t_codes: torch.Tensor,  # (B, T) uint8, left-padded by w_pad + 2
    t_lens: torch.Tensor,  # (B,) int32
    offsets: torch.Tensor,  # (B,) int32
    k_locals: torch.Tensor,  # (B,) int32
    matrix: torch.Tensor,  # (256, 256) int8
    *,
    gap_open: int,
    gap_extend: int,
    rows_max: int,
    w_pad: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Band fill on the card: ``(tb, best, best_i, best_j)`` as :func:`fill_band_plain`.

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
    check_tensor("matrix", matrix, torch.int8, (256, 256), device)
    if matrix.data_ptr() % 16:
        raise ValueError("matrix: expected a 16-byte aligned tensor")
    if not 3 <= w_pad <= lib.kts_swg_max_w_pad():
        raise ValueError(f"w_pad={w_pad} outside the fill kernel's range [3, {lib.kts_swg_max_w_pad()}]")
    if rows_max < 1 or T < 1:
        raise ValueError(f"empty bucket geometry (rows_max={rows_max}, T={T})")

    tb = torch.empty((B, rows_max, w_pad), dtype=torch.uint8, device=device)
    best = torch.empty(B, dtype=torch.int32, device=device)
    best_i = torch.empty(B, dtype=torch.int32, device=device)
    best_j = torch.empty(B, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.kts_swg_fill(
        q_codes.data_ptr(), t_codes.data_ptr(), q_lens.data_ptr(), t_lens.data_ptr(),
        offsets.data_ptr(), k_locals.data_ptr(), matrix.data_ptr(),
        B, rows_max, w_pad, T, int(gap_open), int(gap_extend),
        tb.data_ptr(), best.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"swg fill kernel launch failed: CUDA error {rc}")
    count("swg.cuda.fill")
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
    r"""A (256, 256) substitution matrix as the kernels' contiguous int8 tensor on ``device``.

    Raises when a score does not fit in int8 (the fill keeps the matrix as
    int8 in shared memory).
    """
    m = matrix if isinstance(matrix, torch.Tensor) else torch.from_numpy(np.array(matrix))
    if m.dtype != torch.int8:
        if int(m.min()) < -128 or int(m.max()) > 127:
            raise ValueError("substitution scores must fit in int8 for the CUDA kernels")
        m = m.to(torch.int8)
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
