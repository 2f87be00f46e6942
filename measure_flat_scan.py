#!/usr/bin/env python3
"""Time the port's minimizer scans on one NVIDIA GPU: the flat scan's tiled kernel, and both scans'
run-time forms beside another checkout's kernels on the same inputs.

Run from the root of a checkout on a machine with a CUDA card::

    python3 measure_flat_scan.py [--parent DIR]

It imports the port alone (no jax, no ``kaptive_tpu``) and measures on the
input of ``chip_smoke.py`` step 12(c): the four largest of bench.py's eight
5.3 Mb assemblies (seed 2026) as one (4, 5,767,168) code stream; its first
two rows, sentinel-padded, are a row-compact batch of 2 x 45,056 rows; and on
step 12(f)'s 1 Mb stream (``range_panels.scan_stream``, seed 2026).

1. This checkout's tiled flat kernel (``minimizer_scan_cuda``) and front
   door (``ops/minimizer.py::minimizer_scan`` on the CUDA tensor) at w = 10,
   and the kernel at w = 1 and 32, with CUDA events beside the kernel's bound
   (11 bytes a position: a code read; ``selected``, an int64 hash and a
   strand written), and the ``-Xptxas -v`` report of the run-time form's two
   instances (``scan_rt_kernel<1>`` flat, ``<0>`` row-compact).
2. With ``--parent DIR``: DIR's ``kaptive_tpu_torch/csrc/scan.cu`` (C entries
   ``kts_minimizer_scan`` and ``kts_rowcompact_scan`` for the tiled kernels,
   and the run-time form of four kernels through device memory,
   ``kts_minimizer_scan_any(codes, B, L, k, w, selected, hashes, strands,
   keys, spans_a, spans_b, stream)`` and ``kts_rowcompact_scan_any(codes, B,
   R, halo_rows, k, w, hashes, aux, counts, keys, spans_a, spans_b, strands,
   selected, stream)`` with scratch its wrapper allocated a call) is built
   with the port's nvcc flags into ``build/measure_flat_scan/``, beside this
   checkout's ``scan.cu`` with its run-time tile (``RT_TILE``) doubled to
   8,192 positions.  Each input is timed in the order parent, change, change,
   parent, and the parent's outputs must equal this checkout's: the tiled
   kernels at (15, 10); the flat run-time form at (17, 40), (19, 19), (21, 11)
   and (15, 1100) on the (4, 5,767,168) stream; the row-compact run-time form
   at (17, 40), (19, 19) and (15, 1100) on 2 x 45,056 rows; both at
   (15, 1100) on the 1 Mb stream.  Then the 8,192-position build against
   this one (8,192, 4,096, 4,096, 8,192) at (17, 40) and (15, 1100) on the
   large inputs, outputs equal.  DIR may hold only that file, e.g. ``git
   archive <parent> kaptive_tpu_torch/csrc/scan.cu | tar -x -C DIR``.

Every line names the card (``nvidia-smi`` name and power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from measure_common import assert_no_jax, build_sources, parent_change  # noqa: E402
REPS = 20  # calls a time is the mean of
RT_TILE = "constexpr int RT_TILE = 4096;"  # this checkout's run-time tile, doubled in the variant
FLAT_KW = ((17, 40), (19, 19), (21, 11), (15, 1100))
ROWCOMPACT_KW = ((17, 40), (19, 19), (15, 1100))


def _build_others(parent: Path, out: Path) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """DIR's scan.cu and this checkout's with an 8,192-position run-time tile, built in parallel
    with the port's nvcc flags."""
    from kaptive_tpu_torch.ops.scan_cuda import _declare

    src = (ROOT / "kaptive_tpu_torch" / "csrc" / "scan.cu").read_text()
    if src.count(RT_TILE) != 1:
        raise RuntimeError(f"scan.cu: no single `{RT_TILE}` to double")
    libs = build_sources({"parent_scan": (parent / "kaptive_tpu_torch" / "csrc" / "scan.cu").read_text(),
                          "tile8192_scan": src.replace(RT_TILE, RT_TILE.replace("4096", "8192"))}, out)
    parent_lib, variant = libs["parent_scan"][0], libs["tile8192_scan"][0]
    _declare(variant)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("kts_minimizer_scan", [ptr, i32, i64, i32, i32] + [ptr] * 4),
                       ("kts_rowcompact_scan", [ptr] + [i32] * 5 + [ptr] * 4),
                       ("kts_minimizer_scan_any", [ptr, i32, i64, i32, i64] + [ptr] * 7),
                       ("kts_rowcompact_scan_any", [ptr] + [i32] * 4 + [i64] + [ptr] * 9)):
        getattr(parent_lib, name).restype = i32
        getattr(parent_lib, name).argtypes = args
    return parent_lib, variant


def _flat(lib, codes, k: int, w: int, scratch: bool):
    """A flat-scan C entry on a (B, L) stream: ``(selected, int64 hashes, strands)``; with
    ``scratch``, the parent's run-time form and the three int64 buffers its wrapper allocated."""
    import torch

    B, L = codes.shape
    dev = codes.device
    out = (torch.empty((B, L), dtype=torch.bool, device=dev), torch.empty((B, L), dtype=torch.int64, device=dev),
           torch.empty((B, L), dtype=torch.bool, device=dev))
    stream = torch.cuda.current_stream().cuda_stream
    if scratch:
        words = torch.empty((3, B * L), dtype=torch.int64, device=dev)
        rc = lib.kts_minimizer_scan_any(codes.data_ptr(), B, L, k, w, *(x.data_ptr() for x in out),
                                        *(x.data_ptr() for x in words), stream)
    elif (k, w) == (15, 10):
        rc = lib.kts_minimizer_scan(codes.data_ptr(), B, L, k, w, *(x.data_ptr() for x in out), stream)
    else:
        rc = lib.kts_minimizer_scan_any(codes.data_ptr(), B, L, k, w, *(x.data_ptr() for x in out), stream)
    if rc != 0:
        raise RuntimeError(f"flat scan at ({k}, {w}): CUDA error {rc}")
    return out


def _rowcompact(lib, codes, k: int, w: int, scratch: bool):
    """A row-compact C entry on a (B, R + 16, 128) batch: ``(hashes, aux, counts)``; with
    ``scratch``, the parent's run-time form and the buffers its wrapper allocated."""
    import torch

    from kaptive_tpu_torch.ops.scan import HALO_ROWS, SLOTS

    B, r_pad, row = codes.shape
    R = r_pad - 2 * HALO_ROWS
    dev = codes.device
    out = tuple(torch.empty(shape, dtype=torch.int32, device=dev) for shape in ((B, R, SLOTS), (B, R, SLOTS), (B, R, 1)))
    stream = torch.cuda.current_stream().cuda_stream
    if scratch:
        words = torch.empty((3, B * R * row), dtype=torch.int64, device=dev)
        bytes_ = torch.empty((2, B * R * row), dtype=torch.uint8, device=dev)
        rc = lib.kts_rowcompact_scan_any(codes.data_ptr(), B, R, HALO_ROWS, k, w, *(x.data_ptr() for x in out),
                                         *(x.data_ptr() for x in words), *(x.data_ptr() for x in bytes_), stream)
    elif (k, w) == (15, 10):
        rc = lib.kts_rowcompact_scan(codes.data_ptr(), B, R, HALO_ROWS, k, w, *(x.data_ptr() for x in out), stream)
    else:
        rc = lib.kts_rowcompact_scan_any(codes.data_ptr(), B, R, HALO_ROWS, k, w, *(x.data_ptr() for x in out),
                                         stream)
    if rc != 0:
        raise RuntimeError(f"row-compact scan at ({k}, {w}): CUDA error {rc}")
    return out


def _same(a, b) -> bool:
    import torch

    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def main() -> int:
    import numpy as np
    import torch
    from chip_smoke import SCAN_OPS_PER_POSITION, SEED, _bound, _flat_bound, _named_stream, _timed, build_workload
    from range_panels import scan_stream

    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops import scan_cuda
    from kaptive_tpu_torch.ops.minimizer import DEFAULT_K, DEFAULT_W, minimizer_scan
    from kaptive_tpu_torch.ops.scan import add_halo
    from kaptive_tpu_torch.ops.scan_cuda import minimizer_scan_cuda, rowcompact_scan_cuda
    from kaptive_tpu_torch.parallel.screen import encode_assemblies_to_batch
    from kaptive_tpu_torch.utils.device import card_info, require_cuda

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="a checkout of the design to compare with")
    opts = parser.parse_args()
    require_cuda()
    card = card_info()
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    lib = scan_cuda.build()
    report = [e for e in scan_cuda.LIBRARY.ptxas_report().split(" | ") if e.startswith("scan_rt_kernel")]
    print(f"# ptxas {scan_cuda.LIBRARY.source.name}, the run-time form: {' | '.join(report)} [{card}]", flush=True)

    _, assemblies, _ = build_workload(8)
    largest = sorted(assemblies, key=lambda a: -len(a[3]))[:4]
    genomes = [GenomeAssembly.from_stream(_named_stream(name, fasta), name) for name, *_, fasta in largest]
    codes = torch.from_numpy(encode_assemblies_to_batch(genomes)).cuda()
    padded = add_halo(codes[:2].contiguous())
    mb = torch.from_numpy(scan_stream(np.random.default_rng(SEED), 8192 * 128))[None].cuda()
    mb_padded = add_halo(mb)
    bound = _flat_bound(codes.numel())
    print(f"# stream {tuple(codes.shape)}, {codes.numel():,} positions; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} [{card}]", flush=True)

    def rc_bound(x, got) -> dict:
        n_bytes = x.numel() + sum(g.numel() * g.element_size() for g in got)
        return _bound(n_bytes, x.numel() * SCAN_OPS_PER_POSITION)

    def share(ms: float, b: dict) -> str:
        return f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}: {100 * b['bound_ms'] / ms:.1f}% of it"

    # 1. This checkout's tiled flat kernel.
    for w in (1, DEFAULT_W, 32):
        ms = _timed(lambda: minimizer_scan_cuda(codes, DEFAULT_K, w), REPS)
        print(f"# tiled flat kernel, k = {DEFAULT_K}, w = {w}: {ms:.4f} ms, {share(ms, bound)} [{card}]", flush=True)
    front = _timed(lambda: minimizer_scan(codes, DEFAULT_K, DEFAULT_W), REPS)
    print(f"# front door (minimizer_scan), w = {DEFAULT_W}: {front:.4f} ms [{card}]", flush=True)

    # 2. The parent's kernels on the same inputs: parent, change, change, parent; then the
    #    8,192-position tile against this checkout's 4,096.
    if opts.parent:
        parent, variant = _build_others(opts.parent.resolve(), ROOT / "build" / "measure_flat_scan")
        cases = [("tiled flat", codes, _flat, minimizer_scan_cuda, (15, 10)),
                 ("tiled row-compact", padded, _rowcompact, rowcompact_scan_cuda, (15, 10))]
        cases += [("flat run-time", codes, _flat, minimizer_scan_cuda, kw) for kw in FLAT_KW]
        cases += [("row-compact run-time", padded, _rowcompact, rowcompact_scan_cuda, kw) for kw in ROWCOMPACT_KW]
        cases += [("flat run-time, 1 Mb", mb, _flat, minimizer_scan_cuda, (15, 1100)),
                  ("row-compact run-time, 1 Mb", mb_padded, _rowcompact, rowcompact_scan_cuda, (15, 1100))]
        for label, x, parent_entry, change_fn, (k, w) in cases:
            run_time = (k, w) != (15, 10)
            got = change_fn(x, k, w)
            if not _same(parent_entry(parent, x, k, w, run_time), got):
                raise AssertionError(f"the parent's {label} scan at ({k}, {w}) and this one differ")
            b = _flat_bound(x.numel()) if parent_entry is _flat else rc_bound(x, got)
            del got
            p_ms, c_ms = parent_change(lambda: parent_entry(parent, x, k, w, run_time), lambda: change_fn(x, k, w),
                                       lambda fn: _timed(fn, REPS))
            ms = sum(c_ms) / 2
            print(f"# {label} ({k}, {w}) on {tuple(x.shape)}: parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, change "
                  f"{c_ms[0]:.4f} / {c_ms[1]:.4f} ms; change {share(ms, b)}, parent "
                  f"{100 * b['bound_ms'] / (sum(p_ms) / 2):.1f}% [{card}]", flush=True)
            torch.cuda.empty_cache()
        for label, x, entry, change_fn, (k, w) in (
                ("flat run-time", codes, _flat, minimizer_scan_cuda, (17, 40)),
                ("flat run-time", codes, _flat, minimizer_scan_cuda, (15, 1100)),
                ("row-compact run-time", padded, _rowcompact, rowcompact_scan_cuda, (17, 40)),
                ("row-compact run-time", padded, _rowcompact, rowcompact_scan_cuda, (15, 1100))):
            if not _same(entry(variant, x, k, w, False), change_fn(x, k, w)):
                raise AssertionError(f"the 8,192-position tile's {label} scan at ({k}, {w}) differs")
            v_ms, c_ms = parent_change(lambda: entry(variant, x, k, w, False), lambda: change_fn(x, k, w),
                                       lambda fn: _timed(fn, REPS))
            print(f"# {label} ({k}, {w}) on {tuple(x.shape)}: tile 8,192 {v_ms[0]:.4f} / {v_ms[1]:.4f} ms "
                  f"({variant.kts_scan_any_smem(k, w)} B shared), tile 4,096 {c_ms[0]:.4f} / {c_ms[1]:.4f} ms "
                  f"({lib.kts_scan_any_smem(k, w)} B shared) [{card}]", flush=True)
            torch.cuda.empty_cache()

    assert_no_jax()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
