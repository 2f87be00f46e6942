r"""ctypes binding of the Hopper Viterbi kernels (``csrc/viterbi.cu``).

Replaces the XLA programs ``kaptive_tpu/bgc/genefinder.py::_viterbi_states``
(the gene HMM's forward ``lax.scan`` and reverse backtrace) and
``kaptive_tpu/bgc/kernels.py::architectural_viterbi`` (the architectural
max-plus decode).  The library is compiled at first use
(:mod:`kaptive_tpu_torch.utils.nvcc`) and loaded with ctypes; nothing is
compiled at import.

``gene_viterbi_kernel``: one warp per chain; lane 0 runs the recursion with
the seven scores in registers while the warp stages the next 128 positions'
inputs and stores the packed backpointers (seven 3-bit source states in one
word a position), then walks the words back from the end.
``arch_viterbi_kernel``: one block per contig, one thread per state, the
backtrace by one thread.  The design notes are at the head of the source.

Each wrapper checks device, dtype, shape and contiguity, reads the chain
offsets on the host and checks them as the plain forms do, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream,
raises if the launch returns a CUDA error, and counts the launch as
``viterbi.cuda.gene`` / ``viterbi.cuda.arch`` in
:mod:`kaptive_tpu_torch.utils.metrics`.  There is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kaptive_tpu_torch.ops.viterbi import chain_bounds
from kaptive_tpu_torch.utils.metrics import count
from kaptive_tpu_torch.utils.nvcc import CudaLibrary, check_tensor


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.kts_arch_max_states.restype = i32
    lib.kts_arch_max_states.argtypes = []
    lib.kts_gene_viterbi.restype = i32
    lib.kts_gene_viterbi.argtypes = [ptr] * 4 + [i32, i64, f32, f32] + [ptr] * 3
    lib.kts_arch_viterbi.restype = i32
    lib.kts_arch_viterbi.argtypes = [ptr] * 3 + [i32, i64, i32] + [ptr] * 4


LIBRARY = CudaLibrary("viterbi.cu", _declare)


def build() -> ctypes.CDLL:
    r"""Compile (when the source is newer than the library) and load the kernels."""
    return LIBRARY.load()


def _chain_lengths(offsets: torch.Tensor, device: torch.device, total: int) -> np.ndarray:
    r"""The lengths of the chains ``offsets`` bounds, read on the host and checked as the
    plain forms check them (:func:`chain_bounds`): the kernels trust every bound."""
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"offsets: expected a 1-D tensor of chains + 1 bounds, got {tuple(offsets.shape)}")
    check_tensor("offsets", offsets, torch.int64, (offsets.shape[0],), device)
    return np.diff(chain_bounds(offsets, total))


def gene_viterbi_cuda(
    codemit: torch.Tensor, entry_b: torch.Tensor, exit_b: torch.Tensor, offsets: torch.Tensor,
    *, indel: float, ins_extend: float,
) -> torch.Tensor:
    r"""Gene-HMM Viterbi on the card: (sum Lp,) int8 states, as :func:`gene_viterbi_plain`."""
    device = codemit.device
    if device.type != "cuda":
        raise ValueError(f"gene_viterbi_cuda expects CUDA tensors, got {device}")
    lib = build()
    total = codemit.shape[0] if codemit.dim() == 1 else -1
    for name, x in (("codemit", codemit), ("entry_b", entry_b), ("exit_b", exit_b)):
        check_tensor(name, x, torch.float32, (total,), device)
    n_chains = len(_chain_lengths(offsets, device, total))
    states = torch.empty(total, dtype=torch.int8, device=device)
    if n_chains == 0 or total == 0:
        return states
    back = torch.empty(total, dtype=torch.int32, device=device)  # packed backpointers, scratch
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.kts_gene_viterbi(
        codemit.data_ptr(), entry_b.data_ptr(), exit_b.data_ptr(), offsets.data_ptr(),
        n_chains, total, float(indel), float(ins_extend), back.data_ptr(), states.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"gene Viterbi kernel launch failed: CUDA error {rc}")
    count("viterbi.cuda.gene")
    return states


def arch_viterbi_cuda(
    emissions: torch.Tensor, transitions: torch.Tensor, offsets: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Architectural Viterbi on the card: ``(paths (sum N,) int32, scores (contigs,) float32)``,
    as :func:`arch_viterbi_plain`.  Every contig needs at least one row."""
    device = emissions.device
    if device.type != "cuda":
        raise ValueError(f"arch_viterbi_cuda expects CUDA tensors, got {device}")
    lib = build()
    if emissions.dim() != 2:
        raise ValueError(f"emissions: expected (rows, states), got {tuple(emissions.shape)}")
    rows, S = emissions.shape
    check_tensor("emissions", emissions, torch.float32, (rows, S), device)
    lengths = _chain_lengths(offsets, device, rows)
    if (lengths < 1).any():
        raise ValueError("arch_viterbi: every contig needs at least one emission row")
    n_contigs = len(lengths)
    check_tensor("transitions", transitions, torch.float32, (S, S), device)
    if not 1 <= S <= lib.kts_arch_max_states():
        raise ValueError(f"{S} states outside the kernel's range [1, {lib.kts_arch_max_states()}]")
    paths = torch.empty(rows, dtype=torch.int32, device=device)
    scores = torch.empty(n_contigs, dtype=torch.float32, device=device)
    if n_contigs == 0:
        return paths, scores
    back = torch.empty((rows, S), dtype=torch.uint8, device=device)  # backpointers, scratch
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.kts_arch_viterbi(
        emissions.data_ptr(), transitions.data_ptr(), offsets.data_ptr(), n_contigs, rows, S,
        back.data_ptr(), paths.data_ptr(), scores.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"architectural Viterbi kernel launch failed: CUDA error {rc}")
    count("viterbi.cuda.arch")
    return paths, scores
