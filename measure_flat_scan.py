#!/usr/bin/env python3
"""Time the port's flat minimizer scan on one NVIDIA GPU, beside another checkout's kernel.

Run from the root of a checkout on a machine with a CUDA card::

    python3 measure_flat_scan.py [--parent DIR]

It imports the port alone (no jax, no ``kaptive_tpu``) and measures on the
input of ``chip_smoke.py`` step 12(c): the four largest of bench.py's eight
5.3 Mb assemblies (seed 2026) as one (4, 5,767,168) code stream.

1. This checkout's kernel (``minimizer_scan_cuda``) and front door
   (``ops/minimizer.py::minimizer_scan`` on the CUDA tensor) at w = 10, and
   the kernel at w = 1 and 32, with CUDA events beside the kernel's bound
   (11 bytes a position: a code read; ``selected``, an int64 hash and a
   strand written), and the ``-Xptxas -v`` report of its instances.
2. With ``--parent DIR``: DIR's ``kaptive_tpu_torch/csrc/scan.cu`` (the flat
   kernel of one thread a position, whose C entry ``kts_minimizer_scan``
   takes the same arguments and writes int32 hash bits) is built with the
   port's nvcc flags into ``build/measure_flat_scan/``.  Its front door is
   what that checkout's ``minimizer_scan`` ran: the kernel, then the hash
   bits read as int64 values (``x.to(torch.int64) & 0xFFFFFFFF``).  The
   parent's outputs must equal this checkout's; both kernels and both front
   doors are timed in the order parent, change, change, parent.

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


def _build_parent(parent: Path, out: Path) -> tuple[ctypes.CDLL, str]:
    """DIR's scan.cu built with the port's nvcc flags; returns the library and its flat kernel's
    ``-Xptxas -v`` line (registers, shared memory)."""
    from kaptive_tpu_torch.ops.scan_cuda import _declare

    src = (parent / "kaptive_tpu_torch" / "csrc" / "scan.cu").read_text()
    loaded, output = build_sources({"parent_scan": src}, out)["parent_scan"]
    report, flat = "?", False
    for ln in output.splitlines():
        if "Compiling entry function" in ln:
            flat = "minimizer_scan_kernel" in ln
        elif flat and "Used" in ln:
            report = ln.split("ptxas info    :")[-1].strip()
    _declare(loaded)
    return loaded, report


def _parent_kernel(lib: ctypes.CDLL, codes, k: int, w: int):
    """The parent's kernel as its wrapper launched it: ``(selected, int32 hash bits, strands)``."""
    import torch

    B, L = codes.shape
    selected = torch.empty((B, L), dtype=torch.bool, device=codes.device)
    hashes = torch.empty((B, L), dtype=torch.int32, device=codes.device)
    strands = torch.empty((B, L), dtype=torch.bool, device=codes.device)
    rc = lib.kts_minimizer_scan(codes.data_ptr(), B, L, k, w, selected.data_ptr(), hashes.data_ptr(),
                                strands.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent flat-scan kernel: CUDA error {rc}")
    return selected, hashes, strands


def _parent_front_door(lib: ctypes.CDLL, codes, k: int, w: int):
    """The parent's ``minimizer_scan`` on a CUDA tensor: its kernel, then the hash bits as int64 values."""
    import torch

    selected, hashes, strands = _parent_kernel(lib, codes.to(torch.uint8).contiguous(), k, w)
    return selected, hashes.to(torch.int64) & 0xFFFFFFFF, strands


def main() -> int:
    import torch
    from chip_smoke import _flat_bound, _named_stream, _timed, build_workload

    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops import scan_cuda
    from kaptive_tpu_torch.ops.minimizer import DEFAULT_K, DEFAULT_W, minimizer_scan
    from kaptive_tpu_torch.ops.scan_cuda import minimizer_scan_cuda
    from kaptive_tpu_torch.parallel.screen import encode_assemblies_to_batch
    from kaptive_tpu_torch.utils.device import card_info, require_cuda

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, help="a checkout of the design to compare with")
    opts = parser.parse_args()
    require_cuda()
    card = card_info()
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    scan_cuda.build()
    print(f"# ptxas {scan_cuda.LIBRARY.source.name}: {scan_cuda.LIBRARY.ptxas_report()}", flush=True)

    _, assemblies, _ = build_workload(8)
    largest = sorted(assemblies, key=lambda a: -len(a[3]))[:4]
    genomes = [GenomeAssembly.from_stream(_named_stream(name, fasta), name) for name, *_, fasta in largest]
    codes = torch.from_numpy(encode_assemblies_to_batch(genomes)).cuda()
    bound = _flat_bound(codes.numel())
    print(f"# stream {tuple(codes.shape)}, {codes.numel():,} positions; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} [{card}]", flush=True)

    # 1. This checkout.
    for w in (1, DEFAULT_W, 32):
        ms = _timed(lambda: minimizer_scan_cuda(codes, DEFAULT_K, w), REPS)
        print(f"# kernel, k = {DEFAULT_K}, w = {w}: {ms:.4f} ms, {100 * bound['bound_ms'] / ms:.1f}% of the bound "
              f"[{card}]", flush=True)
    front = _timed(lambda: minimizer_scan(codes, DEFAULT_K, DEFAULT_W), REPS)
    print(f"# front door (minimizer_scan), w = {DEFAULT_W}: {front:.4f} ms [{card}]", flush=True)

    # 2. The parent's kernel and front door on the same stream: parent, change, change, parent.
    if opts.parent:
        lib, report = _build_parent(opts.parent.resolve(), ROOT / "build" / "measure_flat_scan")
        print(f"# parent ptxas: {report}", flush=True)
        got = minimizer_scan(codes, DEFAULT_K, DEFAULT_W)
        want = _parent_front_door(lib, codes, DEFAULT_K, DEFAULT_W)
        torch.cuda.synchronize()
        for field, g, x in zip(("selected", "hashes", "strands"), got, want):
            if g.dtype != x.dtype or not torch.equal(g, x):
                raise AssertionError(f"the parent's flat scan and this one differ on {field}")
        del got, want
        for what, parent_fn, change_fn in (
            ("kernel", lambda: _parent_kernel(lib, codes, DEFAULT_K, DEFAULT_W),
             lambda: minimizer_scan_cuda(codes, DEFAULT_K, DEFAULT_W)),
            ("front door", lambda: _parent_front_door(lib, codes, DEFAULT_K, DEFAULT_W),
             lambda: minimizer_scan(codes, DEFAULT_K, DEFAULT_W)),
        ):
            p_ms, c_ms = parent_change(parent_fn, change_fn, lambda fn: _timed(fn, REPS))
            print(f"# {what}, parent / change / change / parent: {p_ms[0]:.4f} / {c_ms[0]:.4f} / {c_ms[1]:.4f} / "
                  f"{p_ms[1]:.4f} ms [{card}]", flush=True)

    assert_no_jax()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
