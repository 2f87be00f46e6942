r"""Host minimizer scan, contig index and upload packing (counterpart of ``kaptive_tpu.ops.minimizer``).

Re-homed unchanged from the JAX module, which imports ``jax`` at the top: the
2-bit DNA encoding, the sentinel-separated flat code stream, the numpy
minimizer scan (canonical k-mers, murmur3 finalizer hash, ``w``-window
minimum, leftmost on ties), :class:`ContigIndex` and the 2-bit packing of the
device upload.  In host-seeded mode the assembly never goes to the device:
the native C scan in ``native/hostio.cpp`` seeds straight from
:attr:`ContigIndex.codes`.  In device-seeded mode the packed stream is
uploaded and :func:`unpack_2bit_with_bits` (torch) restores the codes on the
device for the row-compact scan (:mod:`kaptive_tpu_torch.ops.scan`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kaptive_tpu.core.seq import Sequences

# DNA byte -> 2-bit code LUT (A=0 C=1 G=2 T/U=3, else 4). Complement = 3-code.
DNA_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    DNA_CODE_LUT[_c] = _i
    DNA_CODE_LUT[_c + 32] = _i
DNA_CODE_LUT[ord("U")] = 3
DNA_CODE_LUT[ord("u")] = 3
DNA_CODE_LUT.flags.writeable = False

SENTINEL = 4  # invalid base code
UINT32_MAX = np.uint32(0xFFFFFFFF)

DEFAULT_K = 15
DEFAULT_W = 10

EXC_CAP = 1 << 15  # exception capacity of the native stream builder (Ns + sentinels)


def encode_dna(seqs: np.ndarray) -> np.ndarray:
    r"""Byte -> 2-bit code encoding."""
    return DNA_CODE_LUT[seqs]


def bucket_length(n: int, minimum: int = 1 << 16) -> int:
    r"""Quantised stream length: powers of two below 512 KiB, 512 KiB steps above.

    Kept from the JAX package so both build the same code stream (the padding
    is sentinels, which yield no minimizers).
    """
    step = 1 << 19
    if n > step:
        return -(-n // step) * step
    size = minimum
    while size < n:
        size *= 2
    return size


def concat_with_sentinels(
    codes: np.ndarray, offsets: np.ndarray, lengths: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    r"""Concatenate per-sequence code arrays with ``k-1`` sentinels between them.

    Returns (flat_codes, seq_starts); the flat array is sentinel-padded to
    :func:`bucket_length`.
    """
    n = len(offsets)
    gap = k - 1
    total = int(lengths.sum()) + gap * max(n - 1, 0)
    alloc = bucket_length(max(total, 1))
    flat = np.full(alloc, SENTINEL, dtype=np.uint8)
    starts = np.zeros(n, dtype=np.int64)
    pos = 0
    for i in range(n):
        ln = int(lengths[i])
        starts[i] = pos
        flat[pos : pos + ln] = codes[offsets[i] : offsets[i] + ln]
        pos += ln + gap
    return flat, starts


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    r"""Pack base codes 4 per byte, first position in the low bits (sentinels pack as 0).

    The length must be a multiple of 4 (bucket padding guarantees it); the
    sentinel mask travels separately (:func:`pack_valid_bits`, or the sparse
    exception list).
    """
    clean = np.where(codes < 4, codes, 0).astype(np.uint8)
    quads = clean.reshape(-1, 4)
    return (
        quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    ).astype(np.uint8)


def pack_valid_bits(codes: np.ndarray) -> np.ndarray:
    r"""Bit-pack the validity mask (code < 4) 8 positions per byte (LSB first)."""
    valid = (codes < SENTINEL).astype(np.uint8)
    return np.packbits(valid.reshape(-1, 8), axis=-1, bitorder="little").reshape(-1)


def unpack_2bit_with_bits(packed: torch.Tensor, valid_bits: torch.Tensor, length: int) -> torch.Tensor:
    r"""2-bit codes + bit-packed validity mask -> (..., length) uint8 codes, on their device.

    Batched over leading dimensions: ``packed`` is (..., length/4) and
    ``valid_bits`` (..., length/8) uint8.
    """
    p = packed.to(torch.uint8)
    lead = p.shape[:-1]
    quads = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3], -1).reshape(*lead, length)
    vb = valid_bits.to(torch.uint8)
    bits = torch.stack([(vb >> i) & 1 for i in range(8)], -1).reshape(*lead, length)
    return torch.where(bits == 1, quads, SENTINEL).to(torch.uint8)


def minimizer_scan_host(codes: np.ndarray, k: int = DEFAULT_K, w: int = DEFAULT_W):
    r"""Minimizer selection over a flat code array: ``(selected, hashes, strands)``.

    ``selected`` marks positions that start a selected minimizer k-mer,
    ``hashes`` is the canonical k-mer hash per position (``UINT32_MAX`` where
    invalid) and ``strands`` is True where the forward packing was canonical.
    """
    L = len(codes)
    c = codes.astype(np.uint32)
    bad = (c >= SENTINEL).astype(np.int32)
    fwd = np.zeros(L, dtype=np.uint32)
    rev = np.zeros(L, dtype=np.uint32)
    badsum = np.zeros(L, dtype=np.int32)
    for j in range(k):
        cj = np.roll(c, -j)
        fwd |= cj << np.uint32(2 * (k - 1 - j))
        rev |= (np.uint32(3) - cj) << np.uint32(2 * j)
        badsum += np.roll(bad, -j)
    valid = (badsum == 0) & (np.arange(L) < L - k + 1)
    canonical = np.minimum(fwd, rev)
    strands = fwd <= rev
    # murmur3 32-bit finalizer
    x = canonical.copy()
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    hashes = np.where(valid, x, UINT32_MAX)

    best = hashes.copy()
    best_pos = np.arange(L, dtype=np.int32)
    for j in range(1, w):
        cand = np.roll(hashes, -j)
        cand_pos = np.arange(L, dtype=np.int32) + j
        take = cand < best
        best = np.where(take, cand, best)
        best_pos = np.where(take, cand_pos, best_pos)
    window_valid = (best != UINT32_MAX) & (np.arange(L) < L - k - w + 2)
    selected = np.zeros(L, dtype=bool)
    selected[best_pos[window_valid]] = True
    selected &= valid
    return selected, hashes, strands


@dataclass(frozen=True, slots=True)
class MinimizerSet:
    r"""Compacted minimizers of a sequence batch, with a sorted lookup table."""

    hashes: np.ndarray  # (N,) uint32, sorted ascending
    seq_indices: np.ndarray  # (N,) int32
    positions: np.ndarray  # (N,) int32 position within the sequence
    strands: np.ndarray  # (N,) bool — forward packing was canonical
    n_seqs: int
    k: int
    w: int


def build_minimizer_set(seqs: Sequences, k: int = DEFAULT_K, w: int = DEFAULT_W) -> MinimizerSet:
    r"""Extract and hash-sort (stably) the minimizers of a ragged sequence batch (host scan)."""
    if len(seqs) == 0 or len(seqs.seqs) == 0:
        e = np.empty(0)
        return MinimizerSet(
            e.astype(np.uint32), e.astype(np.int32), e.astype(np.int32), e.astype(bool), 0, k, w
        )
    codes = encode_dna(seqs.seqs)
    flat, starts = concat_with_sentinels(codes, seqs.offsets, seqs.lengths, k)
    sel, hashes, strands = minimizer_scan_host(flat, k, w)
    pos = np.flatnonzero(sel)
    h = hashes[pos]
    st = strands[pos]
    seq_idx = np.searchsorted(starts, pos, side="right").astype(np.int32) - 1
    local = (pos - starts[seq_idx]).astype(np.int32)
    order = np.argsort(h, kind="stable")
    h, seq_idx, local, st = h[order], seq_idx[order], local[order], st[order]
    return MinimizerSet(h.astype(np.uint32), seq_idx, local, st.astype(bool), len(seqs), k, w)


@dataclass(frozen=True, slots=True)
class ContigIndex:
    r"""Per-assembly mapping index: the flat 2-bit contig stream (+ lazy host minimizers).

    ``_cache["host_chains"]`` holds chains pre-seeded by the streaming ingest
    pool, keyed by the ``(GeneIndex, MapperParams)`` they were seeded against.
    ``_cache["native_pack"]`` holds the native stream build's sparse upload
    parts ``(packed, exceptions, real_len, n_exceptions)`` for device seeding.
    """

    codes: np.ndarray  # flat encoded contigs (with sentinels, bucket-padded)
    starts: np.ndarray  # (n_contigs,) start of each contig within codes
    lengths: np.ndarray  # (n_contigs,)
    k: int
    w: int
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def build(cls, contigs: Sequences, k: int = DEFAULT_K, w: int = DEFAULT_W) -> ContigIndex:
        gap = k - 1
        starts = np.zeros(len(contigs.offsets), dtype=np.int64)
        if len(starts) > 1:
            np.cumsum(contigs.lengths[:-1].astype(np.int64) + gap, out=starts[1:])
        try:
            from kaptive_tpu.native import hostio
        except ImportError:  # no C++ compiler: the numpy encode + concat builds the same stream
            flat, _ = concat_with_sentinels(encode_dna(contigs.seqs), contigs.offsets, contigs.lengths, k)
            return cls(flat, starts, contigs.lengths.astype(np.int64), k, w)
        # Native fused encode + sentinel-concat + 2-bit pack + exception scan
        # in one C pass; the pack outputs seed the sparse device upload.
        total = int(contigs.lengths.sum()) + gap * max(len(starts) - 1, 0)
        flat, packed, exc, real, n_exc = hostio.build_contig_stream(
            contigs.seqs, contigs.offsets, contigs.lengths, gap,
            bucket_length(max(total, 1)), EXC_CAP,
        )
        ci = cls(flat, starts, contigs.lengths.astype(np.int64), k, w)
        ci._cache["native_pack"] = (packed, exc, real, n_exc)
        return ci

    @property
    def minimizers(self) -> MinimizerSet:
        r"""Host minimizer set over the flat contig stream (lazy)."""
        if "mins" not in self._cache:
            sel, hashes, strands = minimizer_scan_host(self.codes, self.k, self.w)
            pos = np.flatnonzero(sel)
            seq_idx = np.searchsorted(self.starts, pos, side="right").astype(np.int32) - 1
            local = (pos - self.starts[seq_idx]).astype(np.int32)
            self._cache["mins"] = MinimizerSet(
                hashes[pos].astype(np.uint32), seq_idx, local,
                strands[pos].astype(bool), len(self.starts), self.k, self.w,
            )
        return self._cache["mins"]
