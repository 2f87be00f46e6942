r"""ctypes binding of the Hopper Viterbi kernels (``csrc/viterbi.cu``).

Replaces the XLA programs ``kaptive_tpu/bgc/genefinder.py::_viterbi_states``
(the gene HMM's forward ``lax.scan`` and reverse backtrace) and
``kaptive_tpu/bgc/kernels.py::architectural_viterbi`` (the architectural
max-plus decode).  The library is compiled at first use
(:mod:`kaptive_tpu_torch.utils.nvcc`) and loaded with ctypes; nothing is
compiled at import.

The gene decode runs every strand in chunks of ``kts_gene_chunk()``
positions, all at once, each from a guess (the forward run over the
``kts_gene_warmup()`` positions before it); fix-up rounds on the card re-run
the chunks whose guessed start differs, bit for bit, from the end of the chunk
before, and fill runs of one repeated input (a strand's pad tail) from a
three-step pattern; the backtrace composes each chunk's map of end states.
:func:`gene_chunk_table` cuts the strands here, on the host.  The
architectural decode runs one warp a contig, one lane a state, with a tree
pick and no block barrier, up to ``kts_arch_max_states()`` (256) states; above
that, a thread-block cluster a contig (its states cut among up to 8 CTAs that
share each row through distributed shared memory; ``kts_arch_wide_cluster``
gives the size a launch takes) and a warp a state over the
transitions transposed here (one contiguous predecessor row a state), with
16-bit backpointers (32-bit past 65,536 states).  The design notes are in the
source.

Each wrapper checks device, dtype, shape and contiguity, reads the chain
offsets on the host and checks them as the plain forms do, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream,
raises if a launch returns a CUDA error, and counts the decode as
``viterbi.cuda.gene`` / ``viterbi.cuda.arch`` / ``viterbi.cuda.arch_wide`` in
:mod:`kaptive_tpu_torch.utils.metrics`.  The gene decode waits on the stream
once a fix-up round (it reads how many chunks differ).  There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kaptive_tpu_torch.ops.viterbi import chain_bounds
from kaptive_tpu_torch.utils.metrics import count
from kaptive_tpu_torch.utils.nvcc import CudaLibrary, check_tensor


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name in ("kts_arch_max_states", "kts_gene_chunk", "kts_gene_warmup"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = []
    lib.kts_arch_pitch.restype = i32
    lib.kts_arch_pitch.argtypes = [i32]
    lib.kts_gene_workspace_words.restype = i64
    lib.kts_gene_workspace_words.argtypes = [i64, i64]
    lib.kts_gene_viterbi.restype = i32
    lib.kts_gene_viterbi.argtypes = [ptr] * 5 + [i32] * 4 + [f32, f32] + [ptr] * 3 + [ctypes.POINTER(i64), ptr]
    lib.kts_arch_viterbi.restype = i32
    lib.kts_arch_viterbi.argtypes = [ptr] * 3 + [i32, i64, i32] + [ptr] * 4
    for name in ("kts_arch_wide_bp_bytes", "kts_arch_wide_pitch", "kts_arch_wide_bp_pitch", "kts_arch_wide_work_floats"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [i32]
    lib.kts_arch_viterbi_wide.restype = i32
    lib.kts_arch_viterbi_wide.argtypes = [ptr] * 4 + [i32, i64, i32] + [ptr] * 5
    lib.kts_arch_wide_cluster.restype = i32
    lib.kts_arch_wide_cluster.argtypes = [i32, i32]


LIBRARY = CudaLibrary("viterbi.cu", _declare)


def build() -> ctypes.CDLL:
    r"""Compile (when the source is newer than the library) and load the kernels."""
    return LIBRARY.load()


def _chain_bounds(offsets: torch.Tensor, device: torch.device, total: int) -> np.ndarray:
    r"""The chain bounds ``offsets`` holds, read on the host and checked as the plain forms
    check them (:func:`chain_bounds`): the kernels trust every bound."""
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"offsets: expected a 1-D tensor of chains + 1 bounds, got {tuple(offsets.shape)}")
    check_tensor("offsets", offsets, torch.int64, (offsets.shape[0],), device)
    return chain_bounds(offsets, total)


def gene_chunk_table(bounds: np.ndarray, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    r"""Cut the chains ``bounds`` delimits into chunks of at most ``chunk`` positions.

    Returns ``(chunks, chain_chunks)``: (n, 4) int64 rows of a chunk's
    ``[start, end)``, its chain's start and its chain's index, in chain order;
    and (chains + 1,) int64, the first chunk of each chain and the total.  An
    empty chain has no chunk.
    """
    bounds = np.asarray(bounds, dtype=np.int64)
    per_chain = -(-np.diff(bounds) // chunk)
    chain_chunks = np.concatenate([[0], np.cumsum(per_chain)]).astype(np.int64)
    chain = np.repeat(np.arange(len(per_chain)), per_chain)
    start = bounds[chain] + (np.arange(chain_chunks[-1]) - chain_chunks[chain]) * chunk
    end = np.minimum(start + chunk, bounds[chain + 1])
    return np.stack([start, end, bounds[chain], chain], axis=1).astype(np.int64), chain_chunks


class GeneDecodeStats(NamedTuple):
    r"""What a gene decode did: its chunks, fix-up rounds, chunks re-run in them, and chunks
    filled from a three-step pattern (runs of one repeated input)."""

    chunks: int
    rounds: int
    reruns: int
    filled: int


def _gene_launch(
    codemit: torch.Tensor, entry_b: torch.Tensor, exit_b: torch.Tensor, offsets: torch.Tensor,
    indel: float, ins_extend: float, warmup: int | None = None, chunk: int | None = None,
) -> tuple[torch.Tensor, GeneDecodeStats]:
    r"""The gene decode with the source's warm-up and chunk length (``None``), or others (the
    card tests' forced fix-ups, ``measure_viterbi.py``'s sweep)."""
    device = codemit.device
    if device.type != "cuda":
        raise ValueError(f"gene_viterbi_cuda expects CUDA tensors, got {device}")
    lib = build()
    total = codemit.shape[0] if codemit.dim() == 1 else -1
    for name, x in (("codemit", codemit), ("entry_b", entry_b), ("exit_b", exit_b)):
        check_tensor(name, x, torch.float32, (total,), device)
    bounds = _chain_bounds(offsets, device, total)
    chunk = lib.kts_gene_chunk() if chunk is None else chunk
    table, chain_chunks = gene_chunk_table(bounds, chunk)
    n_chunks, n_chains = len(table), len(bounds) - 1
    states = torch.empty(total, dtype=torch.int8, device=device)
    stats = (ctypes.c_longlong * 4)()
    if n_chunks == 0:
        return states, GeneDecodeStats(0, 0, 0, 0)
    back = torch.empty(total, dtype=torch.int32, device=device)  # packed backpointers, scratch
    workspace = torch.empty(lib.kts_gene_workspace_words(n_chunks, n_chains), dtype=torch.int32, device=device)
    table_d, chain_chunks_d = torch.from_numpy(table).to(device), torch.from_numpy(chain_chunks).to(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.kts_gene_viterbi(
        codemit.data_ptr(), entry_b.data_ptr(), exit_b.data_ptr(), table_d.data_ptr(), chain_chunks_d.data_ptr(),
        n_chunks, n_chains, chunk, lib.kts_gene_warmup() if warmup is None else warmup, float(indel),
        float(ins_extend), back.data_ptr(), states.data_ptr(), workspace.data_ptr(), stats, stream,
    )
    if rc != 0:
        raise RuntimeError(f"gene Viterbi kernels failed: CUDA error {rc}")
    count("viterbi.cuda.gene")
    return states, GeneDecodeStats(*stats)


def gene_viterbi_cuda(
    codemit: torch.Tensor, entry_b: torch.Tensor, exit_b: torch.Tensor, offsets: torch.Tensor,
    *, indel: float, ins_extend: float,
) -> torch.Tensor:
    r"""Gene-HMM Viterbi on the card: (sum Lp,) int8 states, as :func:`gene_viterbi_plain`."""
    return _gene_launch(codemit, entry_b, exit_b, offsets, indel, ins_extend)[0]


def gene_viterbi_cuda_with_stats(
    codemit: torch.Tensor, entry_b: torch.Tensor, exit_b: torch.Tensor, offsets: torch.Tensor,
    *, indel: float, ins_extend: float,
) -> tuple[torch.Tensor, GeneDecodeStats]:
    r""":func:`gene_viterbi_cuda` and what the decode did (:class:`GeneDecodeStats`)."""
    return _gene_launch(codemit, entry_b, exit_b, offsets, indel, ins_extend)


def _gene_viterbi_forced_fixups(
    codemit: torch.Tensor, entry_b: torch.Tensor, exit_b: torch.Tensor, offsets: torch.Tensor,
    *, indel: float, ins_extend: float,
) -> tuple[torch.Tensor, GeneDecodeStats]:
    r"""The gene decode with no warm-up: every chunk but a strand's first starts from the
    start vector, so the fix-up rounds run.  For the card tests; nothing else calls it."""
    return _gene_launch(codemit, entry_b, exit_b, offsets, indel, ins_extend, warmup=0)


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
    lengths = np.diff(_chain_bounds(offsets, device, rows))
    if (lengths < 1).any():
        raise ValueError("arch_viterbi: every contig needs at least one emission row")
    n_contigs = len(lengths)
    check_tensor("transitions", transitions, torch.float32, (S, S), device)
    paths = torch.empty(rows, dtype=torch.int32, device=device)
    scores = torch.empty(n_contigs, dtype=torch.float32, device=device)
    if n_contigs == 0:
        return paths, scores
    stream = torch.cuda.current_stream(device).cuda_stream
    warp = S <= lib.kts_arch_max_states()
    if warp:
        back = torch.empty((rows, lib.kts_arch_pitch(S)), dtype=torch.uint8, device=device)  # backpointers, scratch
        rc = lib.kts_arch_viterbi(
            emissions.data_ptr(), transitions.data_ptr(), offsets.data_ptr(), n_contigs, rows, S,
            back.data_ptr(), paths.data_ptr(), scores.data_ptr(), stream,
        )
    else:
        bp = torch.int16 if lib.kts_arch_wide_bp_bytes(S) == 2 else torch.int32
        pitch = lib.kts_arch_wide_pitch(S)
        tt = torch.full((S, pitch), float("-inf"), dtype=torch.float32, device=device)  # a state's predecessors a row
        tt[:, :S] = transitions.t()
        back = torch.empty((rows, lib.kts_arch_wide_bp_pitch(S)), dtype=bp, device=device)  # backpointers, scratch
        work = torch.empty((n_contigs, lib.kts_arch_wide_work_floats(S)), dtype=torch.float32, device=device)
        with torch.cuda.device(device):  # the launch, and the cluster the device runs, are the tensors' device's
            rc = lib.kts_arch_viterbi_wide(
                emissions.data_ptr(), transitions.data_ptr(), tt.data_ptr(), offsets.data_ptr(), n_contigs, rows, S,
                back.data_ptr(), paths.data_ptr(), scores.data_ptr(), work.data_ptr(), stream,
            )
    if rc != 0:
        raise RuntimeError(f"architectural Viterbi kernel launch failed ({S} states): CUDA error {rc}")
    count("viterbi.cuda.arch" if warp else "viterbi.cuda.arch_wide")
    return paths, scores
