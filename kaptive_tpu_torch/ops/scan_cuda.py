r"""ctypes binding of the Hopper minimizer scans (``csrc/scan.cu``).

:func:`rowcompact_scan_cuda` replaces ``kaptive_tpu/ops/scan_pallas.py::_rowcompact_kernel``;
:func:`minimizer_scan_cuda` replaces the XLA program
``kaptive_tpu/ops/minimizer.py::minimizer_scan`` (the flat scan).  The library
is compiled at first use (:mod:`kaptive_tpu_torch.utils.nvcc`) and loaded with
ctypes; nothing is compiled at import.

Both scans have three forms, picked from ``(k, w)`` alone (:func:`scan_form`).
The tiled kernels (``"tiled"``) take ``k <= kts_scan_tiled_max_k()`` (16) and
``w <= kts_scan_tiled_max_w()`` (32), the main path's (15, 10) among them:
they scan tiles of 4,096 positions of one genome in a block; a thread owns
16 consecutive positions, whose k-mers come from two packed 2-bit words by a
funnel shift and whose window minima come from one prefix/suffix pass with
the window width known at compile time (one instance of each kernel per
``w``; ``k`` is a run-time argument).  Selected positions are marked in a bit
mask of the tile.  The row-compact kernel ranks them inside their row and
stores each row as whole lines; the flat kernel stores every position's
``selected``, int64 hash and strand as whole lines.  The run-time form
(``"any"``) is the same design with ``k`` and ``w`` read at run time: a
tile's run of ``w - 1`` positions before it and ``k - 1 + w - 1`` after it in
shared memory, k-mers of any length from two funnel shifts (the forward and
the reverse uint32 field), a van Herk / Gil-Werman pass in blocks of ``w``
as two segmented block scans of (hash, position) keys; it takes every ``k <=
1024`` and ``w`` whose run fits a block's shared memory
(``kts_scan_any_smem``; ``w`` up to ~8,400 at ``k <= 32``,
``kts_scan_any_max_w``).  Past that, the sparse-table form (``"sparse"``): a
thread a position packs its k codes as the JAX package's uint32 shifts do, a
sparse table of (hash, position) keys in device scratch gives every window's
leftmost minimum, the winners are marked by scatter, and (row-compact) a warp
a row compacts them.  The design notes are in the source.

The wrappers check device, dtype, shape and contiguity, allocate the outputs
with ``torch.empty``, launch on the current stream, raise if the launch
returns a CUDA error, and count each launch as ``scan.cuda.rowcompact`` /
``scan.cuda.flat`` (tiled), ``scan.cuda.rowcompact_any`` /
``scan.cuda.flat_any`` (run-time) or ``scan.cuda.rowcompact_sparse`` /
``scan.cuda.flat_sparse`` (sparse table) in
:mod:`kaptive_tpu_torch.utils.metrics`.  The tiled and run-time forms launch
once and allocate nothing but the outputs.  The sparse-table form takes a
batch in groups of at most :data:`SPARSE_GROUP_POSITIONS` positions, one
launch a group, so its scratch (26 bytes a position) stays under ~0.9 GB.
There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from kaptive_tpu_torch.ops.scan import HALO_ROWS, ROW, SLOTS
from kaptive_tpu_torch.utils.metrics import count
from kaptive_tpu_torch.utils.nvcc import CudaLibrary, check_tensor


SPARSE_GROUP_POSITIONS = 1 << 25  # positions a launch of the sparse-table form takes at most (whole rows)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kts_scan_tiled_max_k.restype = i32
    lib.kts_scan_tiled_max_k.argtypes = []
    lib.kts_scan_tiled_max_w.restype = i32
    lib.kts_scan_tiled_max_w.argtypes = []
    lib.kts_rowcompact_scan.restype = i32
    lib.kts_rowcompact_scan.argtypes = [ptr] + [i32] * 5 + [ptr] * 4
    lib.kts_minimizer_scan.restype = i32
    lib.kts_minimizer_scan.argtypes = [ptr, i32, i64, i32, i32] + [ptr] * 4
    lib.kts_scan_any_smem.restype = i32
    lib.kts_scan_any_smem.argtypes = [i32, i64]
    lib.kts_scan_any_max_w.restype = i64
    lib.kts_scan_any_max_w.argtypes = [i32]
    lib.kts_rowcompact_scan_any.restype = i32
    lib.kts_rowcompact_scan_any.argtypes = [ptr] + [i32] * 4 + [i64] + [ptr] * 4
    lib.kts_minimizer_scan_any.restype = i32
    lib.kts_minimizer_scan_any.argtypes = [ptr, i32, i64, i32, i64] + [ptr] * 4
    lib.kts_rowcompact_scan_sparse.restype = i32
    lib.kts_rowcompact_scan_sparse.argtypes = [ptr] + [i32] * 4 + [i64] + [ptr] * 9
    lib.kts_minimizer_scan_sparse.restype = i32
    lib.kts_minimizer_scan_sparse.argtypes = [ptr, i32, i64, i32, i64] + [ptr] * 7


LIBRARY = CudaLibrary("scan.cu", _declare)
_COUNTER_SUFFIX = {"tiled": "", "any": "_any", "sparse": "_sparse"}  # a form's launch counter, after the scan's


def build() -> ctypes.CDLL:
    r"""Compile (when the source is newer than the library) and load the kernel."""
    return LIBRARY.load()


def scan_form(k: int, w: int) -> str:
    r"""The form of both scan kernels that takes ``(k, w)``: ``"tiled"``, ``"any"`` (run-time) or
    ``"sparse"`` (sparse table)."""
    if k < 1 or w < 1:
        raise ValueError(f"k={k}, w={w}: the scans need k >= 1 and w >= 1")
    lib = build()
    if k <= lib.kts_scan_tiled_max_k() and w <= lib.kts_scan_tiled_max_w():
        return "tiled"
    return "any" if lib.kts_scan_any_smem(int(k), int(w)) else "sparse"


def _groups(B: int, per_row: int):
    r"""Slices of a batch of ``B`` rows of ``per_row`` positions, at most
    :data:`SPARSE_GROUP_POSITIONS` positions (and at least one row) each."""
    step = max(1, SPARSE_GROUP_POSITIONS // max(per_row, 1))
    return [slice(lo, min(lo + step, B)) for lo in range(0, B, step)]


def rowcompact_scan_cuda(codes_padded: torch.Tensor, k: int, w: int):
    r"""Row-compact scan on the card: ``(hashes, aux, counts)`` as :func:`rowcompact_scan_plain`.

    ``codes_padded`` is a contiguous (B, R + 2*HALO_ROWS, 128) uint8 CUDA tensor.
    """
    device = codes_padded.device
    if device.type != "cuda":
        raise ValueError(f"rowcompact_scan_cuda expects a CUDA tensor, got {device}")
    lib = build()
    if codes_padded.dim() != 3 or codes_padded.shape[1] < 2 * HALO_ROWS:
        raise ValueError(f"expected (B, R + {2 * HALO_ROWS}, {ROW}) codes, got {tuple(codes_padded.shape)}")
    B, r_pad = codes_padded.shape[:2]
    check_tensor("codes_padded", codes_padded, torch.uint8, (B, r_pad, ROW), device)
    if codes_padded.data_ptr() % 16:
        raise ValueError("codes_padded: expected a 16-byte aligned tensor (the kernel loads 16 codes at once)")
    form = scan_form(k, w)
    R = r_pad - 2 * HALO_ROWS
    hashes = torch.empty((B, R, SLOTS), dtype=torch.int32, device=device)
    aux = torch.empty((B, R, SLOTS), dtype=torch.int32, device=device)
    counts = torch.empty((B, R, 1), dtype=torch.int32, device=device)
    if B == 0 or R == 0:  # nothing to launch
        return hashes, aux, counts
    with torch.cuda.device(device):  # the launch goes to the current device
        stream = torch.cuda.current_stream(device).cuda_stream
        if form == "tiled":
            rc = lib.kts_rowcompact_scan(
                codes_padded.data_ptr(), B, R, HALO_ROWS, int(k), int(w),
                hashes.data_ptr(), aux.data_ptr(), counts.data_ptr(), stream,
            )
        elif form == "any":
            rc = lib.kts_rowcompact_scan_any(
                codes_padded.data_ptr(), B, R, HALO_ROWS, int(k), int(w),
                hashes.data_ptr(), aux.data_ptr(), counts.data_ptr(), stream,
            )
        else:
            for g in _groups(B, R * ROW):
                n = (g.stop - g.start) * R * ROW
                words = torch.empty((3, n), dtype=torch.int64, device=device)  # keys and two span buffers
                bytes_ = torch.empty((2, n), dtype=torch.uint8, device=device)  # strands and selected
                rc = lib.kts_rowcompact_scan_sparse(
                    codes_padded[g].data_ptr(), g.stop - g.start, R, HALO_ROWS, int(k), int(w),
                    hashes[g].data_ptr(), aux[g].data_ptr(), counts[g].data_ptr(),
                    *(x.data_ptr() for x in words), *(x.data_ptr() for x in bytes_), stream,
                )
                if rc != 0:
                    break
    if rc != 0:
        raise RuntimeError(f"row-compact scan kernel launch failed ({form} form, k={k}, w={w}): CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():  # a graph's launches are counted as it replays
        count(rowcompact_counter(k, w))
    return hashes, aux, counts


def rowcompact_counter(k: int, w: int) -> str:
    r"""The counter a row-compact scan launch of ``(k, w)`` adds to: ``scan.cuda.rowcompact`` and its form's suffix."""
    return "scan.cuda.rowcompact" + _COUNTER_SUFFIX[scan_form(k, w)]


def minimizer_scan_cuda(codes: torch.Tensor, k: int, w: int):
    r"""Flat minimizer scan on the card over a contiguous (B, L) or (L,) uint8 CUDA tensor.

    Returns ``(selected bool, hashes int64, strands bool)`` of the input's
    shape, as :func:`~kaptive_tpu_torch.ops.scan.minimizer_scan_plain` returns
    them: the kernel writes each hash as a value in ``[0, 2^32)``.  Each row is
    its own stream, its end guards at ``L``.
    """
    device = codes.device
    if device.type != "cuda":
        raise ValueError(f"minimizer_scan_cuda expects a CUDA tensor, got {device}")
    lib = build()
    if codes.dim() not in (1, 2):
        raise ValueError(f"expected (L,) or (B, L) codes, got {tuple(codes.shape)}")
    flat = codes.reshape(-1, codes.shape[-1]) if codes.dim() == 2 else codes[None]
    B, L = flat.shape
    check_tensor("codes", flat, torch.uint8, (B, L), device)
    form = scan_form(k, w)
    selected = torch.empty((B, L), dtype=torch.bool, device=device)
    hashes = torch.empty((B, L), dtype=torch.int64, device=device)
    strands = torch.empty((B, L), dtype=torch.bool, device=device)
    if B and L:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            if form == "tiled":
                rc = lib.kts_minimizer_scan(
                    flat.data_ptr(), B, L, int(k), int(w),
                    selected.data_ptr(), hashes.data_ptr(), strands.data_ptr(), stream,
                )
            elif form == "any":
                rc = lib.kts_minimizer_scan_any(
                    flat.data_ptr(), B, L, int(k), int(w),
                    selected.data_ptr(), hashes.data_ptr(), strands.data_ptr(), stream,
                )
            else:
                for g in _groups(B, L):
                    words = torch.empty((3, (g.stop - g.start) * L), dtype=torch.int64, device=device)
                    rc = lib.kts_minimizer_scan_sparse(
                        flat[g].data_ptr(), g.stop - g.start, L, int(k), int(w),
                        selected[g].data_ptr(), hashes[g].data_ptr(), strands[g].data_ptr(),
                        *(x.data_ptr() for x in words), stream,
                    )
                    if rc != 0:
                        break
        if rc != 0:
            raise RuntimeError(f"flat minimizer scan kernel launch failed ({form} form, k={k}, w={w}): "
                               f"CUDA error {rc}")
        count("scan.cuda.flat" + _COUNTER_SUFFIX[form])
    return tuple(x.reshape(codes.shape) for x in (selected, hashes, strands))
