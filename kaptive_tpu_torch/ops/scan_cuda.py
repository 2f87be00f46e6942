r"""ctypes binding of the Hopper row-compact minimizer scan (``csrc/scan.cu``).

Replaces ``kaptive_tpu/ops/scan_pallas.py::_rowcompact_kernel``.  The library
is compiled at first use (:mod:`kaptive_tpu_torch.utils.nvcc`) and loaded with
ctypes; nothing is compiled at import.

The wrapper checks device, dtype, shape and contiguity, allocates the outputs
with ``torch.empty``, launches on the current stream, raises if the launch
returns a CUDA error, and counts each launch as ``scan.cuda.rowcompact`` in
:mod:`kaptive_tpu.utils.metrics`.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from kaptive_tpu.utils.metrics import count

from kaptive_tpu_torch.ops.scan import HALO_ROWS, ROW, SLOTS
from kaptive_tpu_torch.utils.nvcc import CudaLibrary, check_tensor


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.kts_rowcompact_max_k.restype = i32
    lib.kts_rowcompact_max_k.argtypes = []
    lib.kts_rowcompact_max_w.restype = i32
    lib.kts_rowcompact_max_w.argtypes = []
    lib.kts_rowcompact_scan.restype = i32
    lib.kts_rowcompact_scan.argtypes = [ptr] + [i32] * 5 + [ptr] * 4


LIBRARY = CudaLibrary("scan.cu", _declare)


def build() -> ctypes.CDLL:
    r"""Compile (when the source is newer than the library) and load the kernel."""
    return LIBRARY.load()


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
    if not 1 <= k <= lib.kts_rowcompact_max_k() or not 1 <= w <= lib.kts_rowcompact_max_w():
        raise ValueError(f"k={k}, w={w} outside the scan kernel's range "
                         f"(k <= {lib.kts_rowcompact_max_k()}, w <= {lib.kts_rowcompact_max_w()})")
    R = r_pad - 2 * HALO_ROWS
    hashes = torch.empty((B, R, SLOTS), dtype=torch.int32, device=device)
    aux = torch.empty((B, R, SLOTS), dtype=torch.int32, device=device)
    counts = torch.empty((B, R, 1), dtype=torch.int32, device=device)
    if B == 0 or R == 0:  # nothing to launch
        return hashes, aux, counts
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.kts_rowcompact_scan(
        codes_padded.data_ptr(), B, R, HALO_ROWS, int(k), int(w),
        hashes.data_ptr(), aux.data_ptr(), counts.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"row-compact scan kernel launch failed: CUDA error {rc}")
    count("scan.cuda.rowcompact")
    return hashes, aux, counts
