r"""ctypes binding for the native host-IO library (``kaptive_tpu_torch/csrc/hostio.cpp``).

The shared object is built with ``g++ -O3 -march=native`` at first use from
the source shipped in the package into :data:`kaptive_tpu_torch.utils.nvcc.BUILD_DIR`
(the checkout's ``build/kaptive_tpu_torch/``, or the per-user cache of an
installed package), to a temporary name and then ``os.replace``, so two
processes building at once never load a half-written library.  Nothing is compiled at import.  The port needs this
library for FASTA parsing, the contig stream, host seeding and the overlap
cull: where ``g++`` is missing or the build fails, :func:`load` raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from kaptive_tpu_torch.utils.nvcc import BUILD_DIR, CSRC

SOURCE = CSRC / "hostio.cpp"
LIBRARY = BUILD_DIR / "libkaptive_hostio.so"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: list[ctypes.CDLL] = []


def _compile() -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: a C++ compiler is needed to build the port's host library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)


def _declare(lib: ctypes.CDLL) -> None:
    lib.fasta_scan.restype = None
    lib.fasta_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fasta_parse.restype = ctypes.c_int
    lib.fasta_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.encode_dna_2bit.restype = None
    lib.encode_dna_2bit.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.seed_anchors.restype = ctypes.c_int64
    lib.seed_anchors.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.build_contig_stream.restype = ctypes.c_int64
    lib.build_contig_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.cull_overlaps.restype = None
    lib.cull_overlaps.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p,
    ]


def load() -> ctypes.CDLL:
    r"""Compile when missing or older than the source, then load and declare the library (once per process)."""
    with _lock:
        if not _loaded:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                _compile()
            lib = ctypes.CDLL(str(LIBRARY))
            _declare(lib)
            _loaded.append(lib)
    return _loaded[0]


def parse_fasta_bytes(data: bytes) -> list[tuple[str, bytes]]:
    r"""Parse FASTA bytes natively -> list of (name, sequence)."""
    if not data:
        return []
    n_records = ctypes.c_int64(0)
    total_seq = ctypes.c_int64(0)
    load().fasta_scan(data, len(data), ctypes.byref(n_records), ctypes.byref(total_seq))
    nr = n_records.value
    if nr == 0:
        return []
    seq_buf = np.empty(total_seq.value, dtype=np.uint8)
    name_cap = len(data)  # headers can't exceed the input size
    name_buf = np.empty(name_cap, dtype=np.uint8)
    seq_off = np.empty(nr, dtype=np.int64)
    seq_len = np.empty(nr, dtype=np.int64)
    name_off = np.empty(nr, dtype=np.int64)
    name_len = np.empty(nr, dtype=np.int64)
    rc = load().fasta_parse(
        data, len(data),
        seq_buf.ctypes.data_as(ctypes.c_void_p),
        name_buf.ctypes.data_as(ctypes.c_void_p),
        name_cap,
        seq_off.ctypes.data_as(ctypes.c_void_p),
        seq_len.ctypes.data_as(ctypes.c_void_p),
        name_off.ctypes.data_as(ctypes.c_void_p),
        name_len.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError("native FASTA parse failed")
    out = []
    name_bytes = name_buf.tobytes()
    seq_bytes = seq_buf.tobytes()
    for i in range(nr):
        name = name_bytes[name_off[i] : name_off[i] + name_len[i]].decode()
        seq = seq_bytes[seq_off[i] : seq_off[i] + seq_len[i]]
        out.append((name, seq))
    return out


def encode_dna(seqs: np.ndarray) -> np.ndarray:
    r"""Native byte -> 2-bit code encoding."""
    data = np.ascontiguousarray(seqs, dtype=np.uint8)
    out = np.empty(len(data), dtype=np.uint8)
    load().encode_dna_2bit(
        data.tobytes(), len(data), out.ctypes.data_as(ctypes.c_void_p)
    )
    return out


def build_contig_stream(
    seqs: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
    gap: int, alloc: int, exc_cap: int,
):
    r"""Fused encode + sentinel-concat + 2-bit pack + exception scan (one C pass).

    Returns ``(flat_codes[alloc], packed[(real+3)//4], exceptions, real_len,
    n_exc)`` with ``real_len = sum(lengths) + gap * (n_seqs - 1)``; ``n_exc``
    may exceed ``exc_cap`` (only the first ``exc_cap`` positions are
    recorded — callers fall back to the dense upload form then).
    """
    seq_c = np.ascontiguousarray(seqs, dtype=np.uint8)
    off_c = np.ascontiguousarray(offsets, dtype=np.int64)
    len_c = np.ascontiguousarray(lengths, dtype=np.int64)
    n = len(off_c)
    real = int(len_c.sum()) + gap * max(n - 1, 0)
    if alloc < real:
        raise ValueError(f"alloc ({alloc}) must cover the sentinel-gapped stream ({real})")
    flat = np.full(alloc, 4, dtype=np.uint8)
    packed = np.zeros((real + 3) // 4, dtype=np.uint8)
    exc = np.empty(max(exc_cap, 1), dtype=np.int32)
    n_exc = load().build_contig_stream(
        seq_c.ctypes.data_as(ctypes.c_void_p),
        off_c.ctypes.data_as(ctypes.c_void_p),
        len_c.ctypes.data_as(ctypes.c_void_p),
        n, gap,
        flat.ctypes.data_as(ctypes.c_void_p),
        packed.ctypes.data_as(ctypes.c_void_p),
        exc.ctypes.data_as(ctypes.c_void_p),
        exc_cap,
    )
    return flat, packed, exc[: min(n_exc, exc_cap)], real, int(n_exc)


def seed_anchors(
    codes: np.ndarray, k: int, w: int, table_hashes: np.ndarray,
    max_occ: int, cap_out: int = 1 << 17,
    bloom_words: np.ndarray | None = None, bloom_bits: int = 0,
    bucket_starts: np.ndarray | None = None, bucket_shift: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    r"""Native minimizer scan + sorted-table match over a contig code stream.

    Mirrors ``minimizer_scan_host`` + the anchor expansion of
    ``ops.mapper.find_anchors`` in one C pass.  Returns
    ``(table_rows, flat_positions, contig_strands, n_minimizers,
    n_candidates)`` — anchor rows in ascending flat-position order.  Grows the
    output buffers and retries if ``cap_out`` is exceeded (the C call returns
    the exact total either way).  ``bucket_starts``/``bucket_shift``
    optionally bound each table search to one hash-prefix bucket (the same
    index the device match uses).
    """
    codes_c = np.ascontiguousarray(codes, dtype=np.uint8)
    table_c = np.ascontiguousarray(table_hashes, dtype=np.uint32)
    bloom_c = (
        np.ascontiguousarray(bloom_words, dtype=np.uint32)
        if bloom_words is not None else None
    )
    bloom_p = bloom_c.ctypes.data_as(ctypes.c_void_p) if bloom_c is not None else None
    buckets_c = (
        np.ascontiguousarray(bucket_starts, dtype=np.int32)
        if bucket_starts is not None else None
    )
    buckets_p = (
        buckets_c.ctypes.data_as(ctypes.c_void_p) if buckets_c is not None else None
    )
    while True:
        ti = np.empty(cap_out, dtype=np.int32)
        cpos = np.empty(cap_out, dtype=np.int32)
        cstrand = np.empty(cap_out, dtype=np.uint8)
        counts = np.zeros(2, dtype=np.int64)
        n = load().seed_anchors(
            codes_c.ctypes.data_as(ctypes.c_void_p), len(codes_c),
            int(k), int(w),
            table_c.ctypes.data_as(ctypes.c_void_p), len(table_c),
            bloom_p, int(bloom_bits),
            buckets_p, int(bucket_shift),
            int(max_occ), cap_out,
            ti.ctypes.data_as(ctypes.c_void_p),
            cpos.ctypes.data_as(ctypes.c_void_p),
            cstrand.ctypes.data_as(ctypes.c_void_p),
            counts.ctypes.data_as(ctypes.c_void_p),
        )
        if n <= cap_out:
            return ti[:n], cpos[:n], cstrand[:n], int(counts[0]), int(counts[1])
        cap_out = int(n)


def cull_overlaps(
    starts: np.ndarray, ends: np.ndarray, group_key: np.ndarray | None,
    order: np.ndarray, max_overlap_fraction: float,
) -> np.ndarray:
    r"""Greedy overlap cull in one C pass: the kept mask of ``Intervals.cull_overlaps``.

    ``group_key`` is one int64 key a row (``None``: one group); ``order`` the
    rows to visit, first to last, as numpy indices (negative ones count from
    the end).
    """
    starts_c = np.ascontiguousarray(starts, dtype=np.int64)
    ends_c = np.ascontiguousarray(ends, dtype=np.int64)
    n = len(starts_c)
    if len(ends_c) != n or (group_key is not None and len(group_key) != n):
        raise ValueError("starts, ends and group_key must have one entry a row")
    key_c = None if group_key is None else np.ascontiguousarray(group_key, dtype=np.int64)
    order_c = np.asarray(order, dtype=np.int64)
    if order_c.size and (order_c.min() < -n or order_c.max() >= n):
        raise IndexError(f"order holds an index outside [-{n}, {n})")
    order_c = np.ascontiguousarray(np.where(order_c < 0, order_c + n, order_c))
    kept = np.empty(n, dtype=np.bool_)
    load().cull_overlaps(
        starts_c.ctypes.data_as(ctypes.c_void_p),
        ends_c.ctypes.data_as(ctypes.c_void_p),
        None if key_c is None else key_c.ctypes.data_as(ctypes.c_void_p),
        n,
        order_c.ctypes.data_as(ctypes.c_void_p), len(order_c),
        float(max_overlap_fraction),
        kept.ctypes.data_as(ctypes.c_void_p),
    )
    return kept
