#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, type, check, time.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

It needs one card, no network and no jax.  Steps:

1. Print the card's ``name, power.limit`` (``nvidia-smi``), refuse to run
   without CUDA, and build the Hopper kernels (``kaptive_tpu_torch/csrc/swg.cu``
   and ``csrc/scan.cu``, one nvcc each, started together, into ``build/``) and
   the native host library, printing build seconds.
2. Build bench.py's workload: a 140-locus x 18-gene synthetic database and
   eight 5.3 Mb assemblies, two per composition class (clean, diverged,
   fragmented, draft), from seed 2026.
3. Type them through the port's ``stream_type`` on ``cuda`` twice: a priming
   pass, then the measured pass with every launch count set to 0 just before
   and read just after.  Every best-locus call must match the truth, the fill
   and traceback kernels must have launched, and the plain versions must not.
   Prints the phase table and assemblies/s beside the card.
4. One assembly per class is typed again on the CPU (plain PyTorch DP); its
   results must equal the card's exactly.
5. The largest extension bucket and the largest protein bucket of the
   measured pass are re-run through each kernel and its plain version on the
   card: every SwgResult field must be equal, and the traceback bits on the
   rows each query reaches.  Both are timed with CUDA events.
6. The same 8 assemblies are typed device-seeded (``KAPTIVE_SEED_MODE=device``)
   on ``cuda``: a priming pass, then a measured pass with the counts set to 0
   just before and read just after.  All 8 calls must be correct and every
   KaptiveRow equal the host-seeded pass's; the row-compact scan and the SWG
   kernels must have launched, the plain scan not.  Prints the phase table,
   asm/s and the peak device memory.  The pass's largest scan batch is re-run
   through the scan kernel and its plain version: ``hashes``, ``aux`` and
   ``counts`` must be equal; both are timed with CUDA events.

7. The command line: the database's GenBank file and the 8 FASTA files are
   written to a temporary directory and ``python -m kaptive_tpu_torch.cli
   type ... -o -j --pha4ge -l -g -p --batch-size 4 --device cuda --profile``
   runs as a subprocess, host- then device-seeded.  Its TSV must equal the
   in-process rows of step 3 byte for byte, every call must be correct, the
   counters ``--profile`` prints must show the kernels launched and no plain
   version, and ``convert`` of its JSONL must reproduce the TSV.  Prints the
   wall seconds of each run beside the card.
8. Screen mode: ``Serotyper.screen`` on the 8 assemblies on ``cuda``, three
   timed passes with the counts set to 0 just before and read just after
   each (the scan kernel must launch, the plain scan not), then the batch is
   screened again on the card and on the CPU: ``best`` and the tallies must
   be equal, ``weighted`` within ``rtol=1e-6``.  Prints ``screen.overflow``,
   the calls that match the truth (screen mode promises agreement only on
   clean assemblies) and assemblies per second beside the card.
9. CIGAR mode: the 8 assemblies are mapped with ``emit_cigars=True`` in both
   seeding modes on ``cuda``; every statistic of every hit must equal
   count-only mode's, and each CIGAR's M/I/D run sums the hit's spans.  The
   CIGAR traceback kernel must launch, its plain version not.  The largest
   extension bucket is re-run through the kernel and its plain version:
   every output, the whole ``ops`` buffer included, must be equal; both are
   timed with CUDA events.  So is a planted bucket of the same geometry
   (``swg_panels.cigar_bucket``: indel copies and one pair of more than 256
   runs), which must hold I and D runs and at least one overflowed pair.

``python3 chip_smoke.py --measure`` then also measures, before the last lines:

10. bench.py's full 32 assemblies, host- and then device-seeded, typed in
    stream batches of 32 and of 8, three timed passes each after a priming
    pass (every pass and the median printed), and for each mode one more
    batch-32 pass under ``torch.profiler`` for the card's busy share and its
    time per kernel.
11. Synthetic full-size DP buckets (seeded pairs, query lengths within 200 of
    ``rows_max``, ~2% substitutions): kernel == plain, fill and traceback
    times, and band cells per second of the fill.

Any failure raises (non-zero exit).  The last lines are the kernels' JSON
record, the card line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ASSEMBLIES = 8
BATCH_SIZE = 4
SEED = 2026
MEASURE_ASSEMBLIES = 32  # bench.py's count
MEASURE_PASSES = 3
# (alphabet, B, rows_max, w_pad): the extension lattice's full buckets, and a protein one.
SYNTHETIC_BUCKETS = (("nt", 384, 1024, 128), ("nt", 384, 2560, 128), ("nt", 384, 2560, 512),
                     ("aa", 96, 1024, 640))
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]  # bench.py and tests/synthetic.py


def _timed(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls on the card (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _BucketRecorder:
    """Wraps the aligner's ``banded_swg`` to keep the largest bucket per gap model."""

    def __init__(self, inner):
        self.inner = inner
        self.buckets: dict[int, tuple] = {}

    def __call__(self, *args, **kw):
        size = kw["rows_max"] * kw["w_pad"] * int(args[0].shape[0])
        kept = self.buckets.get(kw["gap_open"])
        if kept is None or size > kept[0]:
            self.buckets[kw["gap_open"]] = (size, args, dict(kw))
        return self.inner(*args, **kw)


class _CigarRecorder:
    """Wraps the DP's ``banded_swg_cigars`` (both seeding modes) to keep the largest bucket."""

    def __init__(self, inner):
        self.inner = inner
        self.largest = None

    def __call__(self, *args, **kw):
        size = kw["rows_max"] * kw["w_pad"] * int(args[0].shape[0])
        if self.largest is None or size > self.largest[0]:
            self.largest = (size, args, dict(kw))
        return self.inner(*args, **kw)


class _ScanRecorder:
    """Wraps the mapper's ``rowcompact_scan`` to keep the largest scan batch."""

    def __init__(self, inner):
        self.inner = inner
        self.largest = None

    def __call__(self, codes, k, w):
        if self.largest is None or codes.numel() > self.largest[0].numel():
            self.largest = (codes, k, w)
        return self.inner(codes, k, w)


def _check_scan(codes, k: int, w: int) -> dict:
    """Scan kernel vs plain version on one recorded batch; returns times and the largest difference."""
    import torch

    from kaptive_tpu_torch.ops.scan import rowcompact_scan_plain
    from kaptive_tpu_torch.ops.scan_cuda import rowcompact_scan_cuda

    got = rowcompact_scan_cuda(codes, k, w)
    want = rowcompact_scan_plain(codes, k, w)
    torch.cuda.synchronize()
    max_err = max(int((g.long() - p.long()).abs().max()) for g, p in zip(got, want))
    if max_err != 0 or any(g.shape != p.shape or g.dtype != p.dtype for g, p in zip(got, want)):
        raise AssertionError(f"scan batch: kernel and plain version differ (max |diff| {max_err})")
    times = {"ms": _timed(lambda: rowcompact_scan_cuda(codes, k, w), 20),
             "plain_ms": _timed(lambda: rowcompact_scan_plain(codes, k, w), 2)}
    B, r_pad, _ = codes.shape
    print(f"# scan batch (B, rows) = ({B}, {r_pad - 16}), {int(got[2].sum())} minimizers, max row count "
          f"{int(got[2].max())}: kernel == plain on hashes, aux, counts; kernel {times['ms']:.4f} ms, "
          f"plain {times['plain_ms']:.4f} ms", flush=True)
    return {"max_abs_err": max_err, "shape": (B, r_pad - 16), **times}


def _check_bucket(label: str, args, kw) -> dict:
    """Kernel vs plain version on one recorded bucket; returns times and the largest difference."""
    import torch

    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_plain
    from kaptive_tpu_torch.ops.swg_cuda import swg_fill_cuda, swg_traceback_cuda

    q, q_lens, t, t_lens, offsets, k_locals, matrix = args
    fill_kw = {k: kw[k] for k in ("gap_open", "gap_extend", "rows_max", "w_pad")}
    tb_kw = {k: kw[k] for k in ("rows_max", "w_pad", "t_pad")}
    fill_in = (q, q_lens, t, t_lens, offsets, k_locals, matrix)

    tb_k, *best_k = swg_fill_cuda(*fill_in, **fill_kw)
    tb_p, *best_p = fill_band_plain(*fill_in, **fill_kw)
    res_k = swg_traceback_cuda(tb_k, q, t, *best_k, offsets, **tb_kw)
    res_p = torch.stack(tuple(traceback_plain(tb_p, q, t, *best_p, offsets, **tb_kw)))
    torch.cuda.synchronize()
    reached = torch.arange(kw["rows_max"], device=q.device)[None, :, None] < q_lens.long()[:, None, None]
    tb_diff = (torch.where(reached, tb_k, 0).int() - torch.where(reached, tb_p, 0).int()).abs()
    max_err = max(int((res_k - res_p).abs().max()), int(tb_diff.max()),
                  *(int((a - b).abs().max()) for a, b in zip(best_k, best_p)))
    if max_err != 0:
        raise AssertionError(f"{label} bucket: kernel and plain version differ (max |diff| {max_err})")

    times = {
        "fill_ms": _timed(lambda: swg_fill_cuda(*fill_in, **fill_kw), 20),
        "fill_plain_ms": _timed(lambda: fill_band_plain(*fill_in, **fill_kw), 2),
        "traceback_ms": _timed(lambda: swg_traceback_cuda(tb_k, q, t, *best_k, offsets, **tb_kw), 20),
        "traceback_plain_ms": _timed(lambda: traceback_plain(tb_p, q, t, *best_p, offsets, **tb_kw), 2),
    }
    shape = (int(q.shape[0]), kw["rows_max"], kw["w_pad"])
    live = int((q_lens > 0).sum())
    print(f"# {label} bucket (B, rows_max, w_pad) = {shape}, {live} live pairs: kernel == plain; "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    return {"max_abs_err": max_err, "shape": shape, **times}


def _check_cigar_bucket(args, kw, label: str) -> dict:
    """CIGAR traceback kernel vs plain version on one bucket (both walk the kernel
    fill's bits); returns times, the largest difference and the run counts."""
    import torch

    from kaptive_tpu_torch.ops.swg import traceback_cigar_plain
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda, swg_traceback_cigar_cuda

    q, q_lens, t, t_lens, offsets, k_locals, matrix = args
    fill_kw = {k: kw[k] for k in ("gap_open", "gap_extend", "rows_max", "w_pad")}
    tb_kw = {k: kw[k] for k in ("rows_max", "w_pad", "t_pad")}
    tb, *best = swg_fill_cuda(q, q_lens, t, t_lens, offsets, k_locals,
                              as_kernel_matrix(matrix, q.device), **fill_kw)
    out, ops, n_ops, overflow = swg_traceback_cigar_cuda(tb, q, t, *best, offsets, **tb_kw)
    res_p, ops_p, n_p, over_p = traceback_cigar_plain(tb, q, t, *best, offsets, **tb_kw)
    torch.cuda.synchronize()
    pairs = ((out, torch.stack(tuple(res_p))), (ops, ops_p), (n_ops, n_p), (overflow, over_p))
    if any(g.shape != p.shape or g.dtype != p.dtype for g, p in pairs):
        raise AssertionError(f"{label} CIGAR bucket: kernel and plain outputs differ in shape or dtype")
    max_err = max(int((g.long() - p.long()).abs().max()) for g, p in pairs)
    if max_err != 0:
        raise AssertionError(f"{label} CIGAR bucket: kernel and plain version differ (max |diff| {max_err})")
    times = {"ms": _timed(lambda: swg_traceback_cigar_cuda(tb, q, t, *best, offsets, **tb_kw), 20),
             "plain_ms": _timed(lambda: traceback_cigar_plain(tb, q, t, *best, offsets, **tb_kw), 2)}
    shape = (int(q.shape[0]), kw["rows_max"], kw["w_pad"])
    kinds = torch.where(ops != 0, ops & 0xF, -1)
    runs = {op: int((kinds == code).sum()) for op, code in (("M", 0), ("I", 1), ("D", 2))}
    print(f"# {label} CIGAR bucket (B, rows_max, w_pad) = {shape}, {int((q_lens > 0).sum())} live pairs, "
          f"{int(n_ops.sum())} runs ({runs}), {int(overflow.sum())} overflowed: kernel == plain on the 8 result "
          f"rows and the whole ops buffer; kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms",
          flush=True)
    return {"max_abs_err": max_err, "shape": shape, "runs": runs, "overflowed": int(overflow.sum()), **times}


def _named_stream(name: str, fasta: bytes) -> io.BytesIO:
    """An in-memory FASTA stream that types as assembly ``name``, as its file ``name.fasta`` would."""
    stream = io.BytesIO(fasta)
    stream.name = name
    return stream


def _counters(stderr: str) -> dict[str, int]:
    """The counters ``type --profile`` prints after its phase table."""
    lines = stderr.splitlines()
    out = {}
    for line in lines[lines.index("#  pipeline counters:") + 1:]:
        if not line.startswith("   "):
            break
        name, n = line.split()
        out[name] = int(n)
    return out


def cli_phase(card: str, sources: dict, assemblies, results) -> dict:
    """Step 7: the port's ``type`` and ``convert`` as subprocesses; returns wall seconds per mode."""
    import subprocess

    from kaptive_tpu.serotyping.io import KaptiveRow

    want = KaptiveRow.header() + b"".join(bytes(KaptiveRow.from_result(r)) for r in results)
    truth = [a[1].encode() for a in assemblies]
    env = {k: v for k, v in os.environ.items() if k not in ("KAPTIVE_SEED_MODE", "KAPTIVE_PROFILE")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    gbk = next(name for name in sources if name.endswith(".gbk"))
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, data in sources.items():
            (tmp / name).write_bytes(data)
        fastas = []
        for name, *_, fasta in assemblies:
            (tmp / f"{name}.fasta").write_bytes(fasta)
            fastas.append(f"../{name}.fasta")
        for mode in ("host", "device"):
            cwd = tmp / mode
            cwd.mkdir()
            cmd = [sys.executable, "-m", "kaptive_tpu_torch.cli", "type", f"../{gbk}", *fastas,
                   "-o", "out.tsv", "-j", "out.jsonl", "--pha4ge", "out.pha4ge", "-l", ".", "-g", ".", "-p", ".",
                   "--batch-size", str(BATCH_SIZE), "--device", "cuda", "--seed-mode", mode, "--profile"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, timeout=600)
            walls[mode] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"type --seed-mode {mode} exited {proc.returncode}:\n"
                                     f"{proc.stderr.decode()[-3000:]}")
            counts = _counters(proc.stderr.decode())
            tsv = (cwd / "out.tsv").read_bytes()
            calls = [row.split(b"\t")[4] for row in tsv.splitlines()[1:]]
            if calls != truth:
                raise AssertionError(f"type --seed-mode {mode}: calls {calls} != truth {truth}")
            if tsv != want:
                raise AssertionError(f"type --seed-mode {mode}: TSV differs from the in-process rows")
            kernels = ["swg.cuda.fill", "swg.cuda.traceback"] + (["scan.cuda.rowcompact"] if mode == "device" else [])
            if min(counts.get(k, 0) for k in kernels) == 0 or any(k.split(".")[1] == "plain" for k in counts):
                raise AssertionError(f"type --seed-mode {mode} did not run on the kernels: {counts}")
            n_files = sum(1 for _ in cwd.glob("*_kaptive_results.*"))
            if n_files != 3 * len(assemblies):
                raise AssertionError(f"type --seed-mode {mode}: {n_files} FASTA files, want {3 * len(assemblies)}")
            conv = subprocess.run([sys.executable, "-m", "kaptive_tpu_torch.cli", "convert", "out.jsonl",
                                   "-t", "conv.tsv"], cwd=cwd, env=env, capture_output=True, timeout=300)
            if conv.returncode != 0 or (cwd / "conv.tsv").read_bytes() != tsv:
                raise AssertionError(f"convert of the {mode}-seeded JSONL does not reproduce the TSV: "
                                     f"{conv.stderr.decode()[-2000:]}")
            print(f"# CLI, {mode}-seeded: `type` of {len(assemblies)} assemblies in {walls[mode]:.3f} s wall "
                  f"(process start, database load and kernel load included) [{card}]; TSV == in-process rows, "
                  f"{len(calls)}/{len(assemblies)} correct, `convert` reproduces it; counters "
                  f"{ {k: v for k, v in sorted(counts.items()) if k.startswith(('swg.', 'scan.'))} }",
                  flush=True)
    return walls


def screen_phase(card: str, db, assemblies) -> float:
    """Step 8: screen mode on the card, held to the CPU screen; returns the median asm/s."""
    import statistics

    import numpy as np
    import torch

    from kaptive_tpu.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu.utils.profiling import phase_report, reset_phases
    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.serotyping import Serotyper

    serotyper = Serotyper(db, device="cuda")

    def streams():
        return [_named_stream(name, fasta) for name, *_, fasta in assemblies]

    serotyper.screen(streams())  # priming: tables to the card, first launches
    rates, overflow = [], 0
    reset_phases()
    for _ in range(3):
        reset_metrics()
        t0 = time.perf_counter()
        genomes, best, weighted = serotyper.screen(streams())
        rates.append(len(assemblies) / (time.perf_counter() - t0))
        counts = snapshot()
        if counts.get("scan.cuda.rowcompact", 0) == 0 or counts.get("scan.plain.rowcompact", 0) != 0:
            raise AssertionError(f"the screen did not scan on the kernel: {counts}")
        overflow = counts.get("screen.overflow", 0)
    phases = {name: total / 3 for name, (_, total) in phase_report(stream=io.StringIO()).items()
              if name.startswith("screen.")}

    codes = encode_assemblies_to_batch(genomes)
    tables = ScreenTables.build(db, serotyper.gene_index)
    n_genes = len(db.genes)
    best_c, weighted_c, tallies_c = locus_screen_batch(torch.from_numpy(codes).cuda(), tables, n_genes)
    if not (np.array_equal(best_c.cpu().numpy(), best) and np.array_equal(weighted_c.cpu().numpy(), weighted)):
        raise AssertionError("Serotyper.screen differs from locus_screen_batch on the same batch")
    t0 = time.perf_counter()
    best_p, weighted_p, tallies_p = locus_screen_batch(torch.from_numpy(codes), tables, n_genes)
    cpu_s = time.perf_counter() - t0
    if not torch.equal(tallies_c.cpu(), tallies_p) or not torch.equal(best_c.cpu(), best_p):
        raise AssertionError("screen on the card and on the CPU differ in tallies or best")
    if not torch.allclose(weighted_c.cpu(), weighted_p, rtol=1e-6, atol=0):
        raise AssertionError("screen on the card and on the CPU differ in weighted beyond rtol=1e-6")
    hits = sum(db.loci.ids[int(b)] == a[1] for b, a in zip(best, assemblies))
    rate = statistics.median(rates)
    print(f"# screen: {len(assemblies)} assemblies, codes {codes.shape}, {hits}/{len(assemblies)} best loci match "
          f"the truth ({', '.join(f'{a[2]}:{db.loci.ids[int(b)] == a[1]}' for b, a in zip(best, assemblies))}), "
          f"screen.overflow {overflow}; card == CPU (tallies, best exact; weighted rtol 1e-6; CPU screen "
          f"{cpu_s:.2f} s); {', '.join(f'{r:.3f}' for r in rates)} asm/s, median {rate:.3f} "
          f"(FASTA parse included); seconds per pass: "
          f"{', '.join(f'{k} {v:.4f}' for k, v in sorted(phases.items()))} [{card}]", flush=True)
    return rate


def cigar_phase(serotyper, db, assemblies) -> tuple[dict, int]:
    """Step 9: CIGAR mode on the card in both seeding modes; returns the bucket check and the launches."""
    import dataclasses

    import numpy as np

    from kaptive_tpu.core.alignment import Alignments
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.ops.mapper import map_genes_batch

    genomes = [GenomeAssembly.ensure(_named_stream(name, fasta)) for name, *_, fasta in assemblies]
    names = tuple(str(i) for i in range(len(db.genes)))
    count_only = serotyper.mapper_params
    with_cigars = dataclasses.replace(count_only, emit_cigars=True)
    stats = [f.name for f in dataclasses.fields(Alignments) if f.name != "cigars"]
    recorder = _CigarRecorder(pairwise.banded_swg_cigars)
    launches = 0
    for mode in ("host", "device"):
        plain = map_genes_batch(serotyper.gene_index, genomes, names, count_only, seed_mode=mode, device="cuda")
        pairwise.banded_swg_cigars = recorder
        reset_metrics()
        try:
            hits = map_genes_batch(serotyper.gene_index, genomes, names, with_cigars, seed_mode=mode, device="cuda")
        finally:
            pairwise.banded_swg_cigars = recorder.inner
        counts = snapshot()
        if counts.get("swg.cuda.traceback_cigar", 0) == 0 or counts.get("swg.plain.traceback_cigar", 0) != 0 \
                or counts.get("swg.cuda.traceback", 0) != 0:
            raise AssertionError(f"CIGAR mode ({mode}) did not run the CIGAR traceback kernel: {counts}")
        launches += counts["swg.cuda.traceback_cigar"]
        n_hits = n_empty = n_runs = 0
        for a, got, want in zip(assemblies, hits, plain):
            for field in stats:
                g, w = getattr(got, field), getattr(want, field)
                if not (np.array_equal(g, w) if isinstance(w, np.ndarray) else g == w):
                    raise AssertionError(f"{a[0]} ({mode}): {field} differs between CIGAR and count-only mode")
            for r in range(len(got)):
                ops = got.cigars[r]
                if len(ops) == 0:
                    n_empty += 1
                    continue
                runs, kinds = ops >> 4, ops & 0xF
                m = int(runs[kinds == 0].sum())
                if (m + int(runs[kinds == 1].sum()) != got.q_ends[r] - got.q_starts[r]
                        or m + int(runs[kinds == 2].sum()) != got.t_ends[r] - got.t_starts[r]):
                    raise AssertionError(f"{a[0]} ({mode}): hit {r}'s CIGAR does not sum to its spans")
                n_runs += len(ops)
            n_hits += len(got)
        print(f"# CIGAR mode, {mode}-seeded: {n_hits} hits, statistics == count-only mode, {n_runs} runs, "
              f"every CIGAR sums to its spans ({n_empty} empty: overflowed); traceback_cigar launches "
              f"{counts['swg.cuda.traceback_cigar']}, plain 0", flush=True)
    if recorder.largest is None:
        raise AssertionError("no CIGAR bucket was recorded")
    _, args, kw = recorder.largest
    check = _check_cigar_bucket(args, kw, "largest recorded")
    # The mapper's buckets hold few gaps and no pair past 256 runs: a planted
    # bucket of the same geometry holds the I/D naming and the overflow slot
    # (runs past the last slot overwrite it, then the prefix is reversed).
    planted = _planted_cigar_bucket()
    if planted["overflowed"] < 1 or min(planted["runs"].values()) == 0:
        raise AssertionError(f"the planted CIGAR bucket lacks an overflow or an op kind: {planted}")
    check["max_abs_err"] = max(check["max_abs_err"], planted["max_abs_err"])
    return check, launches


def _planted_cigar_bucket() -> dict:
    """``_check_cigar_bucket`` on ``swg_panels.cigar_bucket`` (indel copies and one pair
    of more than 256 runs) at the largest extension bucket's geometry, (384, 1024, 128)."""
    import numpy as np
    import torch
    from swg_panels import cigar_bucket

    arrays, matrix, go, ge, rows_max, w_pad = cigar_bucket(np.random.default_rng(SEED), 384, 1024, 128)
    args = (*(torch.from_numpy(a).cuda() for a in arrays), torch.from_numpy(matrix))
    kw = {"gap_open": go, "gap_extend": ge, "rows_max": rows_max, "w_pad": w_pad, "t_pad": w_pad + 2}
    return _check_cigar_bucket(args, kw, "planted")


def build_workload(n_assemblies: int, seed: int = SEED):
    """bench.py's database (140 loci x 18 genes) and ``n_assemblies`` 5.3 Mb assemblies
    cycling through its composition classes: ``(db, [(name, truth, class, fasta)],
    {file name: bytes} of the database's GenBank and TOML sources)``."""
    import numpy as np

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from bench import GENOME_MB, KINDS, _compose_fasta
    from synthetic import make_synthetic_db

    from kaptive_tpu.db import Database

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        gbk, truth = make_synthetic_db(Path(tmp), rng, n_loci=140, genes_per_locus=18,
                                       name="BenchDB", keyword="bench_db")
        db = Database.from_genbank(gbk)
        sources = {p.name: p.read_bytes() for p in Path(tmp).iterdir() if p.suffix in (".gbk", ".toml")}
    names = list(truth["loci"])
    flank = int(GENOME_MB * 1e6 / 2)
    assemblies = []
    for i in range(n_assemblies):
        locus = names[rng.integers(0, len(names))]
        kind = KINDS[i % len(KINDS)]
        assemblies.append((f"asm{i}", locus, kind, _compose_fasta(rng, kind, truth["loci"][locus]["seq"], flank)))
    return db, assemblies, sources


def type_all(serotyper, assemblies, batch_size: int):
    """One ``stream_type`` pass over in-memory FASTA streams; raises on any wrong locus call.
    Returns ``(results, host wall seconds)``."""
    from kaptive_tpu_torch.parallel import stream_type

    streams = [_named_stream(name, fasta) for name, *_, fasta in assemblies]
    t_start = time.perf_counter()
    results = list(stream_type(serotyper, streams, batch_size=batch_size))
    elapsed = time.perf_counter() - t_start
    calls = [r.best_locus_name if r is not None else None for r in results]
    wrong = [(a[0], a[2], a[1], c) for a, c in zip(assemblies, calls) if c != a[1]]
    if wrong:
        raise AssertionError(f"wrong locus calls (name, class, truth, call): {wrong}")
    return results, elapsed


def _synthetic_bucket(rng, alphabet: bytes, B: int, rows_max: int, w_pad: int):
    """Seeded pairs near full length: (q, q_lens, t, t_lens, offsets, k_locals) numpy arrays."""
    import numpy as np

    alpha = np.frombuffer(alphabet, np.uint8)
    t_pad = w_pad + 2
    q_lens = rng.integers(max(rows_max - 200, 1), rows_max + 1, B).astype(np.int32)
    q = alpha[rng.integers(0, len(alpha), (B, rows_max))]
    subst = rng.random((B, rows_max)) < 0.02
    target = np.where(subst, alpha[rng.integers(0, len(alpha), (B, rows_max))], q)
    live = np.arange(rows_max)[None, :] < q_lens[:, None]
    q = np.where(live, q, 0).astype(np.uint8)
    t = np.zeros((B, rows_max + 2 * t_pad), np.uint8)
    t[:, t_pad:t_pad + rows_max] = np.where(live, target, 0)
    return q, q_lens, t, q_lens.copy(), np.zeros(B, np.int32), np.full(B, 20, np.int32)


def measure(card: str) -> None:
    """``--measure``: throughput over bench.py's 32 assemblies, the card's busy share, and
    full-size synthetic buckets (see the module docstring, steps 10 and 11)."""
    import statistics

    import numpy as np
    import torch
    from swg_panels import AA, NT, nt_matrix
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kaptive_tpu.core.pairwise import blosum62_matrix
    from kaptive_tpu.utils.profiling import phase_report, reset_phases
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix
    from kaptive_tpu_torch.serotyping import Serotyper

    db, assemblies, _ = build_workload(MEASURE_ASSEMBLIES)
    serotyper = Serotyper(db, device="cuda")
    for mode in ("host", "device"):
        os.environ["KAPTIVE_SEED_MODE"] = mode
        type_all(serotyper, assemblies, MEASURE_ASSEMBLIES)  # priming pass
        for batch in (MEASURE_ASSEMBLIES, 8):
            rates = []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(MEASURE_PASSES):
                reset_phases()
                _, seconds = type_all(serotyper, assemblies, batch)
                rates.append(MEASURE_ASSEMBLIES / seconds)
            print(f"# measure, {mode}-seeded: {MEASURE_ASSEMBLIES} assemblies in stream batches of "
                  f"{batch}, {MEASURE_ASSEMBLIES}/{MEASURE_ASSEMBLIES} correct in each pass: "
                  f"{', '.join(f'{r:.3f}' for r in rates)} asm/s, median {statistics.median(rates):.3f}, "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 1e6:.1f} MB "
                  f"[{card}]; phase table of the last pass (host wall seconds):", flush=True)
            phase_report(stream=sys.stdout)
            sys.stdout.flush()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, seconds = type_all(serotyper, assemblies, MEASURE_ASSEMBLIES)
        per_kernel: dict[str, list[float]] = {}
        for event in prof.events():
            if event.device_type == DeviceType.CUDA:
                per_kernel.setdefault(event.name, []).append(event.device_time_total / 1e3)
        busy_ms = sum(sum(v) for v in per_kernel.values())
        print(f"# measure, {mode}-seeded: profiled batch-{MEASURE_ASSEMBLIES} pass {seconds:.4f} s, "
              f"card busy {busy_ms:.3f} ms = busy share {busy_ms / 1e3 / seconds:.5f} [{card}]; "
              "by device time:", flush=True)
        for name, times in sorted(per_kernel.items(), key=lambda kv: -sum(kv[1]))[:10]:
            print(f"#   {sum(times):9.3f} ms  {len(times):4d} x  {name[:100]}", flush=True)
    os.environ["KAPTIVE_SEED_MODE"] = "host"

    rng = np.random.default_rng(SEED)
    for alpha, B, rows_max, w_pad in SYNTHETIC_BUCKETS:
        protein = alpha == "aa"
        arrays = _synthetic_bucket(rng, AA if protein else NT, B, rows_max, w_pad)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        matrix = as_kernel_matrix(blosum62_matrix() if protein else nt_matrix(), args[0].device)
        kw = dict(gap_open=11 if protein else 4, gap_extend=1 if protein else 2,
                  rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
        times = _check_bucket(f"synthetic {'protein' if protein else 'extension'}", (*args, matrix), kw)
        cells = int(arrays[1].astype(np.int64).sum()) * w_pad
        print(f"#   fill: {cells / times['fill_ms'] / 1e6:.2f} G band-cells/s "
              f"(band cells = sum of q_len x w_pad) [{card}]", flush=True)


def main() -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--measure", action="store_true",
                        help="after the smoke, also run the measurements of steps 6 and 7")
    opts = parser.parse_args()

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from bench import GENOME_MB, KINDS

    from kaptive_tpu.serotyping.io import KaptiveRow
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu.utils.profiling import phase_report, reset_phases
    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.ops import mapper, scan_cuda, swg_cuda
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.utils.device import card_info, require_cuda

    os.environ["KAPTIVE_PROFILE"] = "1"
    os.environ["KAPTIVE_SEED_MODE"] = "host"  # steps 3-5; step 6 is device-seeded
    require_cuda()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source, started together
        for build in [pool.submit(m.build) for m in (swg_cuda, scan_cuda)]:
            build.result()
    build_s = time.perf_counter() - t0
    print(f"# nvcc builds of csrc/swg.cu and csrc/scan.cu (in parallel): {build_s:.1f} s", flush=True)
    for m in (swg_cuda, scan_cuda):
        print(f"# ptxas {m.LIBRARY.source.name}: {m.LIBRARY.ptxas_report()}", flush=True)
    t0 = time.perf_counter()
    from kaptive_tpu.native import hostio  # noqa: F401  (g++ build of native/hostio.cpp)

    print(f"# native hostio build/load: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    db, assemblies, sources = build_workload(N_ASSEMBLIES)
    serotyper = Serotyper(db, device="cuda")
    print(f"# workload: {len(db.loci)} loci, {len(db.genes)} genes, {N_ASSEMBLIES} x {GENOME_MB} Mb "
          f"assemblies ({'/'.join(KINDS)}); set-up {time.perf_counter() - t0:.1f} s", flush=True)

    _, prime_s = type_all(serotyper, assemblies, BATCH_SIZE)
    print(f"# priming pass: {N_ASSEMBLIES}/{N_ASSEMBLIES} correct in {prime_s:.2f} s", flush=True)

    recorder = _BucketRecorder(pairwise.banded_swg)
    pairwise.banded_swg = recorder
    reset_phases()
    reset_metrics()
    try:
        results, elapsed = type_all(serotyper, assemblies, BATCH_SIZE)
    finally:
        pairwise.banded_swg = recorder.inner
    counts = snapshot()
    launches = {name: counts.get(f"swg.cuda.{name}", 0) for name in ("fill", "traceback")}
    plain = {name: counts.get(f"swg.plain.{name}", 0) for name in ("fill", "traceback")}
    print(f"# measured pass: {N_ASSEMBLIES}/{N_ASSEMBLIES} correct in {elapsed:.3f} s = "
          f"{N_ASSEMBLIES / elapsed:.3f} assemblies/s on [{card}]", flush=True)
    print(f"# launches in the measured pass: kernels {launches}, plain versions {plain}", flush=True)
    if min(launches.values()) == 0 or max(plain.values()) != 0:
        raise AssertionError(f"main path did not run on the kernels: {counts}")
    print(f"# phase table of the measured pass (wall seconds on the host clock, [{card}]):", flush=True)
    phase_report(stream=sys.stdout)
    sys.stdout.flush()

    # The CUDA results must equal the plain PyTorch path's on the CPU.
    sample = [KINDS.index(k) for k in KINDS]
    cpu_results = Serotyper(db, device="cpu").batch(
        [_named_stream(assemblies[i][0], assemblies[i][3]) for i in sample]
    )
    for i, cpu in zip(sample, cpu_results):
        if bytes(KaptiveRow.from_result(cpu)) != bytes(KaptiveRow.from_result(results[i])):
            raise AssertionError(f"{assemblies[i][0]}: CUDA and CPU rows differ")
        if cpu.gene_hits.to_dict().keys() != results[i].gene_hits.to_dict().keys():
            raise AssertionError(f"{assemblies[i][0]}: CUDA and CPU gene hits differ")
        for key, want in cpu.gene_hits.to_dict().items():
            if not np.array_equal(np.asarray(results[i].gene_hits.to_dict()[key]), np.asarray(want)):
                raise AssertionError(f"{assemblies[i][0]}: gene_hits.{key} differs")
        if not np.array_equal(cpu.protein_identities, results[i].protein_identities):
            raise AssertionError(f"{assemblies[i][0]}: protein identities differ")
    print(f"# CPU plain path == CUDA path on {len(sample)} assemblies (KaptiveRow bytes, gene hits, "
          "protein identities)", flush=True)

    checks = {}
    for gap_open, label in ((4, "extension"), (11, "protein")):
        if gap_open not in recorder.buckets:
            raise AssertionError(f"no {label} bucket was recorded in the measured pass")
        _, args, kw = recorder.buckets[gap_open]
        checks[label] = _check_bucket(label, args, kw)

    # Device-seeded mode on the same assemblies: its own priming and measured pass.
    os.environ["KAPTIVE_SEED_MODE"] = "device"
    _, prime_s = type_all(serotyper, assemblies, BATCH_SIZE)
    print(f"# device-seeded priming pass: {N_ASSEMBLIES}/{N_ASSEMBLIES} correct in {prime_s:.2f} s", flush=True)
    scans = _ScanRecorder(mapper.rowcompact_scan)
    mapper.rowcompact_scan = scans
    reset_phases()
    reset_metrics()
    torch.cuda.reset_peak_memory_stats()
    try:
        dev_results, dev_elapsed = type_all(serotyper, assemblies, BATCH_SIZE)
    finally:
        mapper.rowcompact_scan = scans.inner
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    dev_counts = snapshot()
    os.environ["KAPTIVE_SEED_MODE"] = "host"
    scan_launches = dev_counts.get("scan.cuda.rowcompact", 0)
    dev_swg = {name: dev_counts.get(f"swg.cuda.{name}", 0) for name in ("fill", "traceback")}
    print(f"# device-seeded measured pass: {N_ASSEMBLIES}/{N_ASSEMBLIES} correct in {dev_elapsed:.3f} s = "
          f"{N_ASSEMBLIES / dev_elapsed:.3f} assemblies/s on [{card}]; peak device memory "
          f"{peak_mb:.1f} MB", flush=True)
    print(f"# counts in the device-seeded pass: {dict(sorted(dev_counts.items()))}", flush=True)
    if scan_launches == 0 or dev_counts.get("scan.plain.rowcompact", 0) != 0:
        raise AssertionError(f"device-seeded pass did not scan on the kernel: {dev_counts}")
    if min(dev_swg.values()) == 0 or dev_counts.get("swg.plain.fill", 0) != 0:
        raise AssertionError(f"device-seeded pass did not run the SWG kernels: {dev_counts}")
    for a, host_r, dev_r in zip(assemblies, results, dev_results):
        if bytes(KaptiveRow.from_result(host_r)) != bytes(KaptiveRow.from_result(dev_r)):
            raise AssertionError(f"{a[0]}: device-seeded and host-seeded rows differ")
    print(f"# device-seeded rows == host-seeded rows on {N_ASSEMBLIES}/{N_ASSEMBLIES} assemblies "
          "(KaptiveRow bytes)", flush=True)
    print(f"# phase table of the device-seeded measured pass (wall seconds on the host clock, [{card}]):",
          flush=True)
    phase_report(stream=sys.stdout)
    sys.stdout.flush()
    if scans.largest is None:
        raise AssertionError("no scan batch was recorded in the device-seeded pass")
    scan_check = _check_scan(*scans.largest)

    cli_walls = cli_phase(card, sources, assemblies, results)
    screen_rate = screen_phase(card, db, assemblies)
    cigar_check, cigar_launches = cigar_phase(serotyper, db, assemblies)

    if opts.measure:
        measure(card)

    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_loaded:
        raise AssertionError(f"jax modules were imported: {jax_loaded}")

    ext, prot = checks["extension"], checks["protein"]
    kernels = [
        {"name": "swg_fill", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg_pallas.py:91", "launches": launches["fill"],
         "max_abs_err": max(ext["max_abs_err"], prot["max_abs_err"]),
         "ms": ext["fill_ms"], "plain_ms": ext["fill_plain_ms"],
         "protein_ms": prot["fill_ms"], "protein_plain_ms": prot["fill_plain_ms"]},
        {"name": "swg_traceback", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg.py:324", "launches": launches["traceback"],
         "max_abs_err": max(ext["max_abs_err"], prot["max_abs_err"]),
         "ms": ext["traceback_ms"], "plain_ms": ext["traceback_plain_ms"],
         "protein_ms": prot["traceback_ms"], "protein_plain_ms": prot["traceback_plain_ms"]},
        {"name": "rowcompact_scan", "route": "cuda", "source": "kaptive_tpu_torch/csrc/scan.cu",
         "replaces": "kaptive_tpu/ops/scan_pallas.py:230", "launches": scan_launches,
         "max_abs_err": scan_check["max_abs_err"], "ms": scan_check["ms"], "plain_ms": scan_check["plain_ms"]},
        {"name": "swg_traceback_cigar", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg.py:526", "launches": cigar_launches,
         "max_abs_err": cigar_check["max_abs_err"], "ms": cigar_check["ms"], "plain_ms": cigar_check["plain_ms"]},
    ]
    print(f"# ms / plain_ms: SWG on the extension bucket {ext['shape']}; protein_ms / protein_plain_ms: "
          f"protein bucket {prot['shape']} (B, rows_max, w_pad); scan on the batch {scan_check['shape']} "
          f"(B, rows); CIGAR traceback on the bucket {cigar_check['shape']}; {N_ASSEMBLIES / elapsed:.3f} asm/s "
          f"host-seeded, {N_ASSEMBLIES / dev_elapsed:.3f} device-seeded; CLI {cli_walls['host']:.3f} / "
          f"{cli_walls['device']:.3f} s wall host / device-seeded; screen {screen_rate:.3f} asm/s [{card}]",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
