r"""Row-compact minimizer scan: front door, plain PyTorch version and stream unpacking.

Counterpart of :mod:`kaptive_tpu.ops.scan_pallas`.  The genome's code stream
is viewed as rows of ``ROW`` = 128 positions, with ``HALO_ROWS`` rows of
sentinel codes above and below.  For each row the scan emits up to ``SLOTS``
= 64 selected minimizers, in position order:

- ``hashes`` (B, R, 64) int32: the canonical k-mer's murmur3 hash as an int32
  bit pattern (view as uint32), ``0xFFFFFFFF`` in the unused slots;
- ``aux``    (B, R, 64) int32: ``col | strand << 7``, -1 in the unused slots;
- ``counts`` (B, R, 1)  int32: the row's true minimizer count, which may
  exceed 64 (the mapper then seeds that genome on the host).

The selection is :func:`kaptive_tpu_torch.ops.minimizer.minimizer_scan_host`'s:
2-bit forward and reverse k-mers, the canonical minimum, the murmur3 fmix32
hash, the ``w``-window minimum with the leftmost position winning ties, no
k-mer within ``k-1`` of the stream end and no window before position 0 or
within ``k+w-2`` of the end.

:func:`rowcompact_scan` routes by the device of its input: a CUDA tensor goes
to the hand-written Hopper kernel (:mod:`kaptive_tpu_torch.ops.scan_cuda`) or
raises; a CPU tensor goes to :func:`rowcompact_scan_plain`.  The plain version
also runs on CUDA tensors when called directly, which is how the kernel is
checked on the card.  Both take any row count (the Pallas kernel wanted a
multiple of its 1024-row tile).

Torch lacks most uint32 kernels, so the plain version computes in int64 with
values kept in ``[0, 2^32)``; the murmur multiplies split each constant into
16-bit halves so every product stays exact.
"""

from __future__ import annotations

import numpy as np
import torch

from kaptive_tpu_torch.ops.minimizer import SENTINEL, unpack_2bit_with_bits
from kaptive_tpu_torch.utils.metrics import count

SLOTS = 64  # per-row output capacity
ROW = 128  # positions per row
HALO_ROWS = 8  # sentinel rows above and below the stream
PAD_POS = HALO_ROWS * ROW  # position padding on each side of the stream
_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    r"""``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``, exact without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    r"""murmur3 32-bit finalizer on int64 values in ``[0, 2^32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    r"""int64 values in ``[0, 2^32)`` as the int32 tensor with the same bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def as_uint32_values(x: torch.Tensor) -> torch.Tensor:
    r"""int32 bit patterns as int64 values in ``[0, 2^32)``."""
    return x.to(torch.int64) & _U32


def compact_lanes(selected: torch.Tensor, payloads, out_slots: int):
    r"""Order-preserving compaction of each row's selected lanes to its first slots.

    Returns ``(live, [compacted payloads], counts)``: ``live`` (..., out_slots)
    marks the filled slots, each payload keeps its dtype with 0 in the slots
    that are not live, and ``counts`` (..., 1) int32 is the number selected,
    which may exceed ``out_slots`` (the excess is dropped).  A rank-by-cumsum
    scatter; the JAX package's butterfly routing fills the same live slots.
    """
    rank = selected.to(torch.int64).cumsum(-1) - 1
    counts = (rank[..., -1:] + 1).to(torch.int32)
    keep = selected & (rank < out_slots)
    slot = torch.where(keep, rank, out_slots)  # one spare slot takes every drop
    shape = (*selected.shape[:-1], out_slots + 1)
    dev = selected.device
    live = torch.zeros(shape, dtype=torch.bool, device=dev).scatter_(-1, slot, keep)
    vals = [
        torch.zeros(shape, dtype=v.dtype, device=dev).scatter_(-1, slot, torch.where(keep, v, 0))
        for v in payloads
    ]
    return live[..., :out_slots], [v[..., :out_slots] for v in vals], counts


def _scan_positions(codes: torch.Tensor, pad: int, length: int, k: int, w: int):
    r"""Per-position minimizer selection over (B, N) int64 codes whose stream of
    ``length`` positions starts at column ``pad``: ``(selected, hashes, strands)``.

    ``hashes`` are int64 in ``[0, 2^32)``, ``0xFFFFFFFF`` where no valid k-mer
    starts.  Reads past column N wrap to its start, as the JAX package's
    rolls do, and the packing is its uint32 packing of the raw codes, so
    ``strands`` agree even where no valid k-mer starts; positions outside the
    stream select nothing.
    """
    B, N = codes.shape
    dev = codes.device
    i64 = torch.int64
    gpos = torch.arange(N, device=dev) - pad
    ext = codes.repeat(1, -(-(N + k) // N))[:, : N + k] if N else codes  # wraps as often as k needs

    fwd = torch.zeros((B, N), dtype=i64, device=dev)
    rev = torch.zeros_like(fwd)
    bad = torch.zeros((B, N), dtype=torch.bool, device=dev)
    for j in range(k):
        c = ext[:, j : j + N]
        bad |= c >= SENTINEL
        fwd |= (c << (2 * (k - 1 - j))) & _U32
        rev |= (((3 - c) & _U32) << (2 * j)) & _U32
    valid = ~bad & (gpos >= 0) & (gpos < length - k + 1)
    strands = fwd <= rev
    hashes = torch.where(valid, _mix32(torch.minimum(fwd, rev)), _U32)

    # Window minimum over w k-mer starts; strict < keeps the leftmost on ties.
    h_ext = torch.cat([hashes, torch.full((B, w), _U32, dtype=i64, device=dev)], 1)
    best = hashes
    best_off = torch.zeros((B, N), dtype=i64, device=dev)
    for j in range(1, w):
        cand = h_ext[:, j : j + N]
        take = cand < best
        best = torch.where(take, cand, best)
        best_off = torch.where(take, j, best_off)
    window_valid = (best != _U32) & (gpos >= 0) & (gpos < length - k - w + 2)
    delta = torch.where(window_valid, best_off, -1)

    # Position p is selected iff the window starting at p-d chose offset d.
    d_ext = torch.cat([torch.full((B, w), -1, dtype=i64, device=dev), delta], 1)
    sel = delta == 0
    for d in range(1, w):
        sel |= d_ext[:, w - d : w - d + N] == d
    return sel & valid, hashes, strands


def minimizer_scan_plain(codes: torch.Tensor, k: int, w: int):
    r"""Flat minimizer scan (``kaptive_tpu.ops.minimizer.minimizer_scan``) over (L,) or (B, L) codes.

    Returns ``(selected, hashes, strands)`` of the input's shape, on its
    device: ``hashes`` as int64 values in ``[0, 2^32)`` (``0xFFFFFFFF`` where
    invalid).  The stream is the whole last axis, so the end guards sit at
    ``L``; :func:`rowcompact_scan_plain` runs the same body over the
    halo-padded rows and compacts the result.  The front door is
    :func:`kaptive_tpu_torch.ops.minimizer.minimizer_scan`.
    """
    count("scan.plain.flat")
    flat = codes.reshape(-1, codes.shape[-1]).to(torch.int64)
    out = _scan_positions(flat, 0, flat.shape[1], k, w)
    return tuple(x.reshape(codes.shape) for x in out)


def rowcompact_scan_plain(codes_padded: torch.Tensor, k: int, w: int):
    r"""Plain PyTorch row-compact scan (``_scan_tile`` + ``_compact_rows`` of the JAX package).

    ``codes_padded`` is (B, R + 2*HALO_ROWS, 128) uint8 on any device; one
    vectorised pass per k-mer offset, window offset and selection offset over
    the whole batch.  Returns ``(hashes, aux, counts)`` as described in the
    module docstring.
    """
    count("scan.plain.rowcompact")
    B, r_pad, row = codes_padded.shape
    if row != ROW or r_pad < 2 * HALO_ROWS:
        raise ValueError(f"expected (B, R + {2 * HALO_ROWS}, {ROW}) codes, got {tuple(codes_padded.shape)}")
    R = r_pad - 2 * HALO_ROWS
    length = R * ROW
    selected, hashes, strands = _scan_positions(
        codes_padded.reshape(B, -1).to(torch.int64), PAD_POS, length, k, w
    )

    interior = slice(PAD_POS, PAD_POS + length)
    sel_m = selected[:, interior].reshape(B, R, ROW)
    h_m = hashes[:, interior].reshape(B, R, ROW)
    col = torch.arange(ROW, dtype=torch.int64, device=codes_padded.device)
    aux = col | (strands[:, interior].reshape(B, R, ROW).to(torch.int64) << 7)
    live, (h, a), counts = compact_lanes(sel_m, (h_m, aux), SLOTS)
    h = as_int32_bits(torch.where(live, h, _U32))
    a = torch.where(live, a, -1).to(torch.int32)
    return h, a, counts


def rowcompact_scan(codes_padded: torch.Tensor, k: int, w: int):
    r"""Row-compact scan front door: the Hopper kernel for CUDA tensors, the plain version on the CPU.

    There is no fallback: a CUDA tensor the kernel cannot take raises.
    """
    if codes_padded.is_cuda:
        from kaptive_tpu_torch.ops import scan_cuda

        return scan_cuda.rowcompact_scan_cuda(codes_padded, k, w)
    if codes_padded.device.type != "cpu":
        raise ValueError(f"rowcompact_scan: unsupported device {codes_padded.device}")
    return rowcompact_scan_plain(codes_padded, k, w)


def add_halo(codes: torch.Tensor) -> torch.Tensor:
    r"""(B, L) codes -> (B, L/128 + 2*HALO_ROWS, 128) with sentinel halo rows."""
    B = codes.shape[0]
    pad = torch.full((B, HALO_ROWS, ROW), SENTINEL, dtype=torch.uint8, device=codes.device)
    return torch.cat([pad, codes.reshape(B, -1, ROW), pad], 1)


def pad_codes_for_scan_any(codes: np.ndarray) -> np.ndarray:
    r"""Host helper: (L,) uint8 codes, L a multiple of 128 -> (L/128 + 16, 128) with sentinel halo rows."""
    body = codes.reshape(-1, ROW)
    pad = np.full((HALO_ROWS, ROW), SENTINEL, dtype=np.uint8)
    return np.concatenate([pad, body, pad], axis=0)


def unpack_to_padded(packed: torch.Tensor, valid_bits: torch.Tensor, length: int) -> torch.Tensor:
    r"""Dense upload form -> scan input: (B, L/4) 2-bit codes and (B, L/8) validity
    bits -> (B, L/128 + 16, 128) sentinel-padded codes, on the device of the inputs."""
    return add_halo(unpack_2bit_with_bits(packed, valid_bits, length))


def unpack_sparse_to_padded(
    packed: torch.Tensor,  # (B, W4) uint8: each genome's real-prefix 2-bit stream, zero-padded
    exceptions: torch.Tensor,  # (B, E) int64: positions of invalid bases, padded with any index >= 4*W4
    real_len: torch.Tensor,  # (B,) int64: true stream length of each genome
    length: int,  # full bucket-padded stream length
) -> torch.Tensor:
    r"""Sparse upload form -> scan input (B, length/128 + 16, 128), on the device of the inputs.

    Positions at or past ``real_len`` and every listed exception become the
    sentinel code; exception indices at or past ``4*W4`` are dropped.
    """
    B, W4 = packed.shape
    n = 4 * W4
    p = packed.to(torch.uint8)
    quads = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3], -1).reshape(B, n)
    idx = torch.arange(n, device=packed.device)
    codes = torch.where(idx[None, :] < real_len[:, None], quads, SENTINEL)
    # One spare column takes the dropped exception indices.
    codes = torch.cat([codes, codes.new_full((B, 1), SENTINEL)], 1)
    codes.scatter_(1, exceptions.clamp(0, n), SENTINEL)
    codes = codes[:, :n]
    if n < length:
        codes = torch.cat([codes, codes.new_full((B, length - n), SENTINEL)], 1)
    return add_halo(codes[:, :length])
