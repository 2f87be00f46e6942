#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, type, check, time.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

It needs one card and no network, and it imports the port alone: neither jax
nor the JAX package ``kaptive_tpu`` (a check before the last lines fails if a
module of either was loaded).  Steps:

1. Print the card's ``name, power.limit`` (``nvidia-smi``), refuse to run
   without CUDA, and build what the port builds, all from
   ``kaptive_tpu_torch/csrc/`` into ``build/kaptive_tpu_torch/`` (the
   checkout's build directory; step 12 builds an installed copy elsewhere): the Hopper
   kernels (``swg.cu``, ``scan.cu`` and ``viterbi.cu``, one nvcc each) and the native host
   library (``hostio.cpp``, g++), started together, printing build seconds.
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
   rows each query reaches.  Both are timed with CUDA events.  Both buckets
   take the fill's warp form; a synthetic protein bucket with ``w_pad`` 1152
   holds the fill's wide form (and the traceback after it) to the plain
   versions too.
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
   runs), which must hold I and D runs and at least one overflowed pair; its
   time is the kernel entry's ``planted_ms``.

10. The BGC toolkit: an ``ArchitecturalTrainer`` (K = 25, D = 1024) learns
    from the database's 140 loci; the clean and the draft assembly are
    annotated on ``cuda`` with ``align=True`` and predicted, with the counts
    set to 0 just before and read just after: the gene and architectural
    Viterbi kernels and the SWG kernels must have launched, no plain form, and
    at least half the planted locus's genes must be among each assembly's top
    hits.  The gene kernel is held to its plain form (on the CPU, one
    thread) on both launches of the main path, whole: the clean assembly's
    two strands of 5,767,168 padded steps and the draft assembly's 48
    strands; then on ``BGC_WINDOWS`` windows of 2-16 kb of each assembly,
    both strands.  Each is timed, and a line gives each launch's chunks,
    fix-up rounds, re-run chunks and chunks filled from a three-step
    pattern.  The architectural kernel is held to its plain form on every
    emission matrix of the main path and timed on the largest.  Annotate +
    predict of a window of at most 60 kb around the planted locus on the card
    must equal the CPU path: BED bytes, alignments, predictions (scores to
    rtol 1e-5).

11. The mesh: four slots, ``cuda:i % device_count()`` for i < 4 (four cards
    where the machine has them, ``cuda:0`` four times on one card).  The 8
    assemblies are typed through ``stream_type(Serotyper(db, mesh=make_mesh(
    devices=slots, model_parallel=m)), batch_size=4)`` for mesh shapes (2, 2)
    and (1, 4), a priming pass and a measured pass each, with the counts set
    to 0 just before and read just after the measured one: every call must be
    correct, every KaptiveRow equal to step 3's, and the scan, fill and
    traceback kernels must have launched and no plain form.  Each pass's wall
    seconds are printed beside the card.  The shards' own launches are
    recorded in the measured passes: the largest extension shard's fill and
    traceback and the largest data row's scan are held to their plain forms
    at those shapes (``mesh_shape``, ``mesh_max_abs_err`` on the ``kernels``
    line).  ``Serotyper(db, mesh=...).screen``
    and ``sharded_locus_screen`` on both shapes must give step 8's single-card
    ``best`` and tallies, ``weighted`` within ``rtol=1e-6``.  Then two
    subprocesses meet through ``parallel.multihost.initialize_distributed``
    (gloo, 127.0.0.1), each types its ``shard_inputs`` slice of the eight
    FASTA files of step 7 on ``cuda`` and writes its ``ShardedJsonlWriter``
    shard; the merged records must equal the in-process
    ``result_to_jsonl_bytes`` records, and each process asserts that no
    ``jax*`` or ``kaptive_tpu*`` module was loaded.
12. The port as users install and call it.  (a) A wheel of the repository's
    packages is built offline (``pip wheel --no-deps --no-build-isolation``)
    from a copy of them and installed with ``--target`` into a temporary
    directory; where setuptools is missing, the tree the wheel would hold is
    copied there instead (the line says which).  The wheel must ship every
    ``csrc/`` source.  (b) ``python -m kaptive_tpu_torch.cli type`` of step
    7's files runs from that directory, with its ``cwd`` outside the checkout
    and ``XDG_CACHE_HOME`` a fresh temporary directory, host- and then
    device-seeded: its TSV must equal step 3's rows byte for byte, the
    kernels must launch and no plain form, the sources must resolve inside
    the installed package and the libraries build in the fresh cache, no
    ``jax*`` or ``kaptive_tpu*`` module may load, and nothing may change under
    the checkout's ``build/``.  Prints each run's wall seconds beside the
    card.  (c) The flat-scan kernel (``minimizer_scan_kernel``) is held to
    ``minimizer_scan_plain`` on the card, exactly on ``selected``, ``hashes``
    and ``strands``: step 3's four largest assemblies as one (4, L) stream of
    ~22 M positions at full width, and the poly-A overflow panel of
    ``tests/scan_panels.py``; the kernel, the front door ``minimizer_scan``
    (which returns the kernel's int64 hashes) and the plain form timed with
    CUDA events beside the kernel's bound (11 bytes a position); the
    ``-Xptxas -v`` registers and spills of the kernel's w = 10 instance.
    (d) Screen mode on four assemblies, one with a 400-base poly-A run, with
    the counts set to 0 just before and read just after: ``screen.overflow``
    must be 1, the flat-scan kernel must launch once and no plain scan run,
    and ``best`` and the tallies must equal the CPU's.  (e) The one-contig
    ``architectural_viterbi`` (24,438 rows x 28 states) launches the
    architectural kernel once and equals its plain form.  (f) The input
    range: the kernel forms for the inputs the main path's forms refuse, each
    driven through a public entry point with the counts set to 0 just before
    and read just after, then held to its plain form on the card and timed
    beside its bound.  The unseeded 150-versus-4,300 protein pair through the
    default ``PairwiseAligner`` (the fill's cluster form at ``w_pad``
    32,768: score 849, 150 matches, q_start 0, t_start 1,000) and through
    ``batched_swg_align_cigars`` (one 150M run); ``batched_swg_align`` with
    BLOSUM62 x 20 (scores outside int8, the cluster form at the planner's
    widths), equal to its CPU path; ``banded_swg`` on a bucket at ``w_pad``
    131,075 (past the largest cluster: the segmented form); ``map_genes_batch`` device-seeded with a
    k = 17, w = 40 ``GeneIndex`` on two assemblies and ``build_minimizer_set``
    at (17, 40) (both scans' run-time form), the recorded scan batch and the
    four-assembly flat stream held to the plain forms, and both scans at w =
    1,100 on a 1 Mb stream; both scans' front doors one window past the
    run-time form's widest (``kts_scan_any_max_w(15) + 1``: the sparse-table
    form) on that stream; an ``ArchitecturalPredictor`` of 254 archetypes
    (257 states: the architectural decode's block-a-contig form, a warp a
    state) on the draft assembly's annotation, equal to its CPU path.  Each
    redesigned form's time is printed beside its bound and share;
    ``measure_input_range.py --parent DIR`` times them beside a parent
    checkout's kernels.

``python3 chip_smoke.py --measure`` then also measures, before the last lines:

13. Synthetic full-size DP buckets (seeded pairs, query lengths within 200 of
    ``rows_max``, ~2% substitutions): kernel == plain, fill and traceback
    times, and band cells per second of the fill.
14. The fill and the traceback at 44, 384 and 1536 live pairs of one shape
    (1024 rows, ``w_pad`` 128): latency against throughput, and whether a
    lattice batch of 384 pairs fills the card.
15. The scan at 1, 4 and 32 genomes of 45,056 rows (seeded random streams):
    kernel == plain at each, CUDA-event time and bound: latency against
    throughput of the scan, and the time of a 32-genome batch in one launch.

Any failure raises (non-zero exit).  The last lines are the kernels' JSON
record, the card line, and ``{"ok": true, "device": {...}}``.

Each kernel's ``bound_ms`` is the least time the card could take for the work
this run's data needs: the larger of the bytes moved (inputs read once,
outputs written once) over 3.35 TB/s and the integer operations over the
card's int32 rate, taken as a quarter of its 67 TFLOP/s float32 rate (half
the lanes, and no multiply-add counted double): 16.75 T operations/s.  No
PyTorch call computes any of the functions, so ``library_ms`` is null.
The two Viterbi kernels are float32 work: their operations are counted
against the 67 TFLOP/s float32 rate, and their bytes are the function's own
inputs and outputs (no scratch of the kernel).  The gene decode's time is
that of a whole call (its kernels, the fix-up rounds' waits on the stream
and the host work between them), queued back to back.
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
# (alphabet, B, rows_max, w_pad): the extension lattice's full buckets, and a protein one.
SYNTHETIC_BUCKETS = (("nt", 384, 1024, 128), ("nt", 384, 2560, 128), ("nt", 384, 2560, 512),
                     ("aa", 96, 1024, 640))
WIDE_FORM_BUCKET = (24, 512, 1152)  # (B, rows_max, w_pad): protein pairs, above the warp form's widths
LIVE_PAIR_STEPS = (44, 384, 1536)  # live pairs of the (1024, 128) shape timed by --measure
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12 / 4  # a quarter of the float32 rate: half the lanes, no multiply-add counted double
FILL_OPS_PER_CELL = 50  # integer operations of the fill's two passes for one band cell
WALK_OPS_PER_STEP = 10  # integer operations of one traceback step
SCAN_OPS_PER_POSITION = 35  # rolling k-mer, hash and sliding-window minimum for one position
SCAN_GENOME_STEPS = (1, 4, 32)  # genomes of 45,056 rows scanned in one launch by --measure
SCAN_ROWS = 45056  # scan rows of one bucket-padded 5.3 Mb assembly
FLOAT32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
GENE_OPS_PER_STEP = 43  # float32 operations of a gene-HMM step: 12 adds, 10 picks, the codon add, 7 clamps, 6 maxima, 7 subtracts
GENE_BYTES_PER_STEP = 13  # 12 bytes in (codon emission, entry and exit scores), a state byte out
BGC_WINDOWS = 32  # windows cut from each of the two annotated assemblies for the gene kernel's check
BGC_WINDOW_SPAN = (2000, 16000)  # their lengths, bases
BGC_CPU_CONTIG = 60000  # the longest contig the BGC phase's CPU check decodes
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]  # bench.py and the tests' workload builders


def _bound(n_bytes: int, n_ops: int) -> dict:
    """``bound_ms`` and ``bound_by`` for work of ``n_bytes`` moved and ``n_ops`` integer operations."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _fill_bound(q_lens, t_cols: int, rows_max: int, w_pad: int) -> dict:
    """The fill's bound: one traceback byte written per band cell of the rows each query
    reaches, the query and target windows, lengths and matrix read once; ~50 operations a cell."""
    rows = int(q_lens.clamp(0, rows_max).long().sum())
    pairs = int(q_lens.numel())
    live = int((q_lens > 0).sum())
    n_bytes = rows * w_pad + rows + live * 2 * w_pad + rows + 65536 + 28 * pairs
    return _bound(n_bytes, rows * w_pad * FILL_OPS_PER_CELL)


def _walk_bound(res, extra_bytes: int = 0) -> dict:
    """A traceback's bound from the walks' own lengths (``res`` is its (8, B) output): a 32-byte
    sector of traceback bits, a query and a target byte per step; 28 bytes in and 32 out per pair."""
    steps = int((res[1] + res[2] + res[3]).long().sum())
    return _bound(steps * 34 + 60 * int(res.shape[1]) + extra_bytes, steps * WALK_OPS_PER_STEP)


def _timed(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls on the card (CUDA events, after one warm-up).

    A short kernel takes less time than its Python wrapper takes to enqueue it,
    so the card is first kept busy for ~10 ms while every call is queued: the
    events then bracket the calls running back to back, not the host's pace.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _CallRecorder:
    """Wraps a kernel front door to keep the arguments of every call."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.inner(*args, **kw)

    def largest_bucket(self, gap_open: int | None = None):
        """``(args, kw)`` of the largest DP bucket recorded (of ``gap_open`` when given), or None."""
        calls = [c for c in self.calls if gap_open is None or c[1]["gap_open"] == gap_open]
        return max(calls, key=lambda c: c[1]["rows_max"] * c[1]["w_pad"] * int(c[0][0].shape[0]), default=None)


def _share(times: dict) -> str:
    """The bound as a share of the kernel's time, for the report lines."""
    return f"{100 * times['bound_ms'] / times['ms']:.1f}% of the bound"


def _check_scan(codes, k: int, w: int) -> dict:
    """Scan kernel vs plain version on one batch; returns times and the largest difference.
    The plain version, which works in int64, takes the batch four genomes at a time."""
    import torch

    from kaptive_tpu_torch.ops.scan import rowcompact_scan_plain
    from kaptive_tpu_torch.ops.scan_cuda import rowcompact_scan_cuda

    got = rowcompact_scan_cuda(codes, k, w)
    max_err = 0
    chunks = range(0, codes.shape[0], 4)
    for lo in chunks:
        want = rowcompact_scan_plain(codes[lo:lo + 4], k, w)
        torch.cuda.synchronize()
        if any(g[lo:lo + 4].shape != p.shape or g.dtype != p.dtype for g, p in zip(got, want)):
            raise AssertionError("scan batch: kernel and plain outputs differ in shape or dtype")
        max_err = max(max_err, *(int((g[lo:lo + 4].long() - p.long()).abs().max()) for g, p in zip(got, want)))
        del want
    if max_err != 0:
        raise AssertionError(f"scan batch: kernel and plain version differ (max |diff| {max_err})")
    times = {"ms": _timed(lambda: rowcompact_scan_cuda(codes, k, w), 20),
             "plain_ms": _timed(lambda: [rowcompact_scan_plain(codes[lo:lo + 4], k, w) for lo in chunks], 2)}
    B, r_pad, _ = codes.shape
    n_bytes = codes.numel() * codes.element_size() + sum(g.numel() * g.element_size() for g in got)
    times.update(_bound(n_bytes, codes.numel() * SCAN_OPS_PER_POSITION))
    print(f"# scan batch (B, rows) = ({B}, {r_pad - 16}), {int(got[2].sum())} minimizers, max row count "
          f"{int(got[2].max())}: kernel == plain on hashes, aux, counts; kernel {times['ms']:.4f} ms, "
          f"plain {times['plain_ms']:.4f} ms; bound {times['bound_ms']:.4f} ms by {times['bound_by']}: the kernel "
          f"runs at {_share(times)}", flush=True)
    return {"max_abs_err": max_err, "shape": (B, r_pad - 16), **times}


def _check_bucket(label: str, args, kw, form: str) -> dict:
    """Kernel vs plain version on one bucket, which must take the fill's ``form``, comparing the
    traceback bits of the rows the queries reach (a 16,384-row bucket's are 8 GB); returns
    times, bounds and the largest difference."""
    import torch

    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_plain
    from kaptive_tpu_torch.ops.swg_cuda import fill_form, swg_fill_cuda, swg_traceback_cuda

    q, q_lens, t, t_lens, offsets, k_locals, matrix = args
    if fill_form(kw["w_pad"], matrix.dtype) != form:
        raise AssertionError(f"{label} bucket: w_pad {kw['w_pad']} takes the fill's "
                             f"{fill_form(kw['w_pad'], matrix.dtype)} form, not the {form} form")
    fill_kw = {k: kw[k] for k in ("gap_open", "gap_extend", "rows_max", "w_pad")}
    tb_kw = {k: kw[k] for k in ("rows_max", "w_pad", "t_pad")}
    fill_in = (q, q_lens, t, t_lens, offsets, k_locals, matrix)

    tb_k, *best_k = swg_fill_cuda(*fill_in, **fill_kw)
    tb_p, *best_p = fill_band_plain(*fill_in, **fill_kw)
    res_k = swg_traceback_cuda(tb_k, q, t, *best_k, offsets, **tb_kw)
    res_p = torch.stack(tuple(traceback_plain(tb_p, q, t, *best_p, offsets, **tb_kw)))
    torch.cuda.synchronize()
    rows = int(q_lens.max())
    reached = torch.arange(rows, device=q.device)[None, :, None] < q_lens.long()[:, None, None]
    tb_diff = (torch.where(reached, tb_k[:, :rows], 0).int() - torch.where(reached, tb_p[:, :rows], 0).int()).abs()
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
    fill_b = _fill_bound(q_lens, int(t.shape[1]), kw["rows_max"], kw["w_pad"])
    walk_b = _walk_bound(res_k)
    print(f"# {label} bucket (B, rows_max, w_pad) = {shape}, {live} live pairs, fill in its {form} form: "
          "kernel == plain; " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"; bounds: fill {fill_b['bound_ms']:.5f} ms by {fill_b['bound_by']}, traceback "
          f"{walk_b['bound_ms']:.6f} ms by {walk_b['bound_by']}", flush=True)
    return {"max_abs_err": max_err, "shape": shape, "fill_bound": fill_b, "traceback_bound": walk_b, **times}


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
    times.update(_walk_bound(out, extra_bytes=ops.numel() * 4 + 5 * int(q.shape[0])))
    kinds = torch.where(ops != 0, ops & 0xF, -1)
    runs = {op: int((kinds == code).sum()) for op, code in (("M", 0), ("I", 1), ("D", 2))}
    print(f"# {label} CIGAR bucket (B, rows_max, w_pad) = {shape}, {int((q_lens > 0).sum())} live pairs, "
          f"{int(n_ops.sum())} runs ({runs}), {int(overflow.sum())} overflowed: kernel == plain on the 8 result "
          f"rows and the whole ops buffer; kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms; bound "
          f"{times['bound_ms']:.5f} ms by {times['bound_by']} (below a launch's own few microseconds): the kernel "
          f"runs at {_share(times)}", flush=True)
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


def write_inputs(tmp: Path, sources: dict, assemblies) -> None:
    """The database's GenBank and TOML sources and one FASTA file an assembly, written to ``tmp``."""
    for name, data in sources.items():
        (tmp / name).write_bytes(data)
    for name, *_, fasta in assemblies:
        (tmp / f"{name}.fasta").write_bytes(fasta)


def cli_phase(card: str, tmp: Path, assemblies, results) -> dict:
    """Step 7: the port's ``type`` and ``convert`` as subprocesses on the files of ``tmp``
    (:func:`write_inputs`); returns wall seconds per mode."""
    import subprocess

    from kaptive_tpu_torch.serotyping.io import KaptiveRow

    want = KaptiveRow.header() + b"".join(bytes(KaptiveRow.from_result(r)) for r in results)
    truth = [a[1].encode() for a in assemblies]
    env = {k: v for k, v in os.environ.items() if k not in ("KAPTIVE_SEED_MODE", "KAPTIVE_PROFILE")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    gbk = next(tmp.glob("*.gbk")).name
    fastas = [f"../{name}.fasta" for name, *_ in assemblies]
    walls = {}
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

    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.utils.profiling import phase_report, reset_phases

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

    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.core.alignment import Alignments
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops.mapper import map_genes_batch
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    genomes = [GenomeAssembly.ensure(_named_stream(name, fasta)) for name, *_, fasta in assemblies]
    names = tuple(str(i) for i in range(len(db.genes)))
    count_only = serotyper.mapper_params
    with_cigars = dataclasses.replace(count_only, emit_cigars=True)
    stats = [f.name for f in dataclasses.fields(Alignments) if f.name != "cigars"]
    recorder = _CallRecorder(pairwise.banded_swg_cigars)
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
    if not recorder.calls:
        raise AssertionError("no CIGAR bucket was recorded")
    args, kw = recorder.largest_bucket()
    check = _check_cigar_bucket(args, kw, "largest recorded")
    # The mapper's buckets hold few gaps and no pair past 256 runs: a planted
    # bucket of the same geometry holds the I/D naming and the overflow slot
    # (runs past the last slot overwrite it, then the prefix is reversed).
    planted = _planted_cigar_bucket()
    if planted["overflowed"] < 1 or min(planted["runs"].values()) == 0:
        raise AssertionError(f"the planted CIGAR bucket lacks an overflow or an op kind: {planted}")
    check["max_abs_err"] = max(check["max_abs_err"], planted["max_abs_err"])
    check["planted_ms"] = planted["ms"]
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


def _gene_bound(offsets) -> dict:
    """The gene decode's bound over the chains that ``offsets`` bounds: the three inputs read
    and the states written once, the offsets read."""
    steps = int(offsets[-1])
    n_bytes = steps * GENE_BYTES_PER_STEP + 8 * len(offsets)
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, steps * GENE_OPS_PER_STEP / FLOAT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _check_gene_launch(label: str, args, kw, card: str, reps: int) -> dict:
    """Gene kernel vs its plain form (on the CPU, one thread) on one launch's inputs: the states
    must be equal.  Prints the shapes compared and what the decode did; returns times, bound,
    the largest difference and the decode's :class:`GeneDecodeStats`."""
    from kaptive_tpu_torch.ops import viterbi_cuda
    from kaptive_tpu_torch.ops.viterbi import gene_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import gene_viterbi_cuda, gene_viterbi_cuda_with_stats

    got, stats = gene_viterbi_cuda_with_stats(*args, **kw)
    got = got.cpu()
    on_cpu = [a.cpu() for a in args]
    want, plain_s = _cpu_seconds(lambda: gene_viterbi_plain(*on_cpu, **kw))
    err = int((got.int() - want.int()).abs().max()) if got.shape == want.shape and len(got) else 0
    if got.shape != want.shape or err:
        raise AssertionError(f"gene Viterbi kernel and plain form differ on {label} (max |diff| {err}, "
                             f"shapes {tuple(got.shape)} and {tuple(want.shape)})")
    check = {"max_abs_err": err, "ms": _timed(lambda: gene_viterbi_cuda(*args, **kw), reps),
             "plain_ms": plain_s * 1e3, **_gene_bound(on_cpu[3]), "stats": stats}
    lengths = on_cpu[3][1:] - on_cpu[3][:-1]
    print(f"# gene Viterbi, {label}: {len(lengths)} strands of {int(lengths.min())}-{int(lengths.max())} padded "
          f"steps, {int(lengths.sum())} in all, in one launch: kernel == plain (states, max |diff| 0); kernel "
          f"{check['ms']:.4f} ms, plain (CPU, one thread) {check['plain_ms']:.1f} ms; bound {check['bound_ms']:.5f} ms "
          f"by {check['bound_by']} [{card}]", flush=True)
    lib = viterbi_cuda.build()
    chunk, warmup = lib.kts_gene_chunk(), lib.kts_gene_warmup()
    print(f"#   {label}: {stats.chunks} chunks of up to {chunk} positions (warm-up {warmup}), {stats.rounds} "
          f"fix-up rounds, {stats.reruns} re-run chunks, {stats.filled} chunks filled from a three-step pattern; "
          f"the longest chain: {warmup + chunk} steps + {stats.rounds} x {chunk} re-run [{card}]", flush=True)
    return check


def _arch_bound(emissions, offsets) -> dict:
    """The architectural decode's bound: emissions, transitions and offsets read once, paths and
    scores written once; an add and a compare a row, state and predecessor."""
    rows, S = emissions.shape
    n_bytes = rows * S * 4 + S * S * 4 + 8 * len(offsets) + rows * 4 + 4 * (len(offsets) - 1)
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, 2 * rows * S * S / FLOAT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _cpu_seconds(fn):
    """``fn()`` on one CPU thread (the plain forms issue many tiny ops); returns ``(result, seconds)``."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)


def _gene_windows(rng, annotator, fastas) -> tuple:
    """``BGC_WINDOWS`` windows of each assembly, both strands, as the gene decode's flat inputs on the CPU."""
    import numpy as np
    import torch

    from kaptive_tpu_torch.bgc.genefinder import _both_strands, _strand_inputs

    strands = []
    for fasta in fastas:
        contigs = [b"".join(rec.split(b"\n")[1:]) for rec in fasta.split(b">")[1:]]
        for _ in range(BGC_WINDOWS):
            seq = contigs[rng.integers(len(contigs))]
            n = int(rng.integers(*BGC_WINDOW_SPAN))
            lo = int(rng.integers(0, len(seq) - n))
            strands += [_strand_inputs(codes, annotator._hmm_params) for codes in _both_strands(seq[lo:lo + n])]
    flat = [torch.from_numpy(np.concatenate([getattr(s, f) for s in strands])) for f in ("codemit", "entry_b", "exit_b")]
    offsets = torch.from_numpy(np.cumsum([0] + [len(s.codemit) for s in strands]).astype(np.int64))
    return (*flat, offsets)


def _planted_hits(annotation, locus: str) -> int:
    """Distinct genes of ``locus`` among the annotation's top hits."""
    return len({str(n) for n in annotation.top_hit_names[annotation.hits_mask] if str(n).startswith(f"{locus}_")})


def _same_predictions(got, want, what: str) -> None:
    """BGCPredictions equal: names and members exactly, scores within rtol 1e-5 (the emissions'
    matrix product and sums run in another order on the card than on the CPU)."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} predicted loci against {len(want)}")
    for name in ("contig_names", "offsets", "lengths", "member_orfs", "member_states"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{what}: BGCPredictions.{name} differs")
    if not np.array_equal(got.member_proteins.seqs, want.member_proteins.seqs):
        raise AssertionError(f"{what}: BGCPredictions.member_proteins differs")
    if not np.allclose(got.scores, want.scores, rtol=1e-5, atol=0):
        raise AssertionError(f"{what}: BGCPredictions.scores differ beyond rtol 1e-5: {got.scores} {want.scores}")


def bgc_phase(card: str, db, assemblies) -> dict:
    """Step 10: the BGC toolkit on the card; returns the two Viterbi kernels' checks and launches."""
    import numpy as np
    import torch
    from bench import GENOME_MB

    from kaptive_tpu_torch.bgc import Annotator, ArchitecturalPredictor, ArchitecturalTrainer
    from kaptive_tpu_torch.bgc import genefinder
    from kaptive_tpu_torch.bgc import kernels as bgc_kernels
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    picked = [next(a for a in assemblies if a[2] == kind) for kind in ("clean", "draft")]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    loci = [db.get_locus_data(name) for name in db.loci.ids if name.startswith("KL")]
    model = ArchitecturalTrainer().train(loci)
    train_s = time.perf_counter() - t0
    print(f"# BGC: trained K = {model.centroids.shape[0]}, D = {model.centroids.shape[1]} on {len(loci)} loci "
          f"x {len(loci[0].proteins)} genes in {train_s:.2f} s", flush=True)
    annotator = Annotator(db, align=True, device="cuda")
    predictor = ArchitecturalPredictor(model, device="cuda")

    # The main path: annotate and predict both assemblies, with the counts set to 0 just before.
    genes_rec, arch_rec = _CallRecorder(genefinder.gene_viterbi), _CallRecorder(bgc_kernels.arch_viterbi)
    genefinder.gene_viterbi, bgc_kernels.arch_viterbi = genes_rec, arch_rec
    results, walls = [], []
    reset_metrics()
    try:
        for name, locus, kind, fasta in picked:
            genome = GenomeAssembly.from_stream(_named_stream(name, fasta), name)
            t0 = time.perf_counter()
            annotation = annotator(genome)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            predicted = predictor.predict(annotation)
            torch.cuda.synchronize()
            walls.append((t1 - t0, time.perf_counter() - t1))
            results.append((annotation, predicted))
    finally:
        genefinder.gene_viterbi, bgc_kernels.arch_viterbi = genes_rec.inner, arch_rec.inner
    counts = snapshot()
    kernels = ("viterbi.cuda.gene", "viterbi.cuda.arch", "swg.cuda.fill", "swg.cuda.traceback")
    if min(counts.get(k, 0) for k in kernels) == 0 or any(".plain." in k for k in counts):
        raise AssertionError(f"the BGC phase did not run on the kernels alone: {counts}")
    for (name, locus, kind, fasta), (annotation, predicted), (ann_s, pred_s) in zip(picked, results, walls):
        found = _planted_hits(annotation, locus)
        wanted = len(db.get_locus_data(locus).proteins)
        aligned = len(annotation.alignments) if annotation.alignments is not None else 0
        print(f"# BGC, {kind} {name} ({GENOME_MB} Mb, {len(annotation.contig_names)} contigs): {len(annotation.genes)} "
              f"genes, {int(annotation.hits_mask.sum())} with a top hit, {found}/{wanted} genes of the planted "
              f"{locus} among them, {aligned} aligned on the card; annotate {ann_s:.2f} s, predict {pred_s:.2f} s: "
              f"{len(predicted)} predicted loci, {int(predicted.lengths.sum())} member ORFs [{card}]", flush=True)
        if 2 * found < wanted:
            raise AssertionError(f"{name}: only {found} of the planted {locus}'s {wanted} genes among the top hits")
    print(f"# BGC launches in the main path: {dict((k, counts.get(k, 0)) for k in kernels)}, plain versions 0",
          flush=True)

    # Kernel 1 against its plain form on the CPU: both launches of the main path, whole, then
    # windows of both assemblies, both strands.
    if len(genes_rec.calls) != len(picked):
        raise AssertionError(f"{len(genes_rec.calls)} gene decode launches for {len(picked)} assemblies")
    gene = {kind: _check_gene_launch(f"the {kind} assembly's launch", *call, card, reps=3)
            for (_, _, kind, _), call in zip(picked, genes_rec.calls)}
    windows = _gene_windows(np.random.default_rng(SEED), annotator, [a[3] for a in picked])
    hmm = dict(indel=annotator._hmm_params.indel, ins_extend=annotator._hmm_params.ins_extend)
    gene["windows"] = _check_gene_launch(f"{BGC_WINDOWS} windows of {BGC_WINDOW_SPAN[0]}-{BGC_WINDOW_SPAN[1]} b "
                                         "of each assembly, both strands", [w.cuda() for w in windows], hmm,
                                         card, reps=5)

    # Kernel 2 against its plain form on every contig's emission matrix of the main path.
    arch_err, arch_rows, arch_plain = 0, 0, []
    for args, _ in arch_rec.calls:
        paths, scores = arch_viterbi_cuda(*args)
        on_cpu = [x.cpu() for x in args]
        (want_p, want_s), plain_s = _cpu_seconds(lambda: arch_viterbi_plain(*on_cpu))
        arch_plain.append((args, plain_s))
        paths, scores = paths.cpu(), scores.cpu()
        if paths.shape != want_p.shape or scores.shape != want_s.shape:
            raise AssertionError("architectural Viterbi kernel and plain form differ in shape")
        score_diff = torch.where(scores == want_s, 0.0, (scores - want_s).abs().nan_to_num(float("inf")))
        arch_err = max(arch_err, int((paths.long() - want_p.long()).abs().max()), float(score_diff.max()))
        arch_rows += int(args[0].shape[0])
    if arch_err != 0:
        raise AssertionError(f"architectural Viterbi kernel and plain form differ (max |diff| {arch_err})")
    args, plain_s = max(arch_plain, key=lambda t: t[0][0].shape[0])
    arch = {"max_abs_err": arch_err, "ms": _timed(lambda: arch_viterbi_cuda(*args), 20),
            "plain_ms": plain_s * 1e3, **_arch_bound(args[0], args[2])}
    print(f"# architectural Viterbi: {len(arch_rec.calls)} launches, {arch_rows} emission rows of "
          f"{args[0].shape[1]} states: kernel == plain (paths and scores, max |diff| {arch_err}); the largest, "
          f"{args[0].shape[0]} rows in {len(args[2]) - 1} contigs: kernel {arch['ms']:.4f} ms, plain (CPU, one "
          f"thread) {arch['plain_ms']:.1f} ms; bound {arch['bound_ms']:.5f} ms by {arch['bound_by']} [{card}]",
          flush=True)

    # One whole annotate + predict on the card held to the CPU path, on a window around the planted locus.
    name, locus, _, fasta = picked[0]
    seq = b"".join(fasta.split(b"\n")[1:])
    flank = int(GENOME_MB * 1e6 / 2)
    pad = min(10_000, (BGC_CPU_CONTIG - (len(seq) - 2 * flank)) // 2)
    span = seq[flank - pad: len(seq) - flank + pad]
    window = b">c1\n%s\n" % span
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            def run(dev=dev):
                annotation = Annotator(db, align=True, device=dev)(GenomeAssembly.from_stream(io.BytesIO(window), "w"))
                return annotation, ArchitecturalPredictor(model, device=dev).predict(annotation)
            (annotation, predicted), seconds = _cpu_seconds(run) if dev == "cpu" else (run(), 0.0)
            annotation.write_bed(Path(tmp) / f"{dev}.bed", hits_only=False)
            out[dev] = (annotation, predicted, (Path(tmp) / f"{dev}.bed").read_bytes(), seconds)
    (a_gpu, p_gpu, bed_gpu, _), (a_cpu, p_cpu, bed_cpu, cpu_s) = out["cuda"], out["cpu"]
    if bed_gpu != bed_cpu:
        raise AssertionError("BGC window: the card's BED bytes differ from the CPU's")
    if not np.array_equal(a_gpu.alignments.scores, a_cpu.alignments.scores):
        raise AssertionError("BGC window: alignment scores differ between the card and the CPU")
    _same_predictions(p_gpu, p_cpu, "BGC window")
    print(f"# BGC window of {len(span)} b around the planted {locus}: Annotator + predict on the card == CPU "
          f"(BED bytes of {len(a_gpu.genes)} genes, {len(a_gpu.alignments)} alignments, {len(p_gpu)} predicted loci; "
          f"scores rtol 1e-5); CPU path {cpu_s:.1f} s", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"# BGC phase: {wall:.1f} s wall (training {train_s:.1f} s, annotate "
          f"{' + '.join(f'{a:.2f}' for a, _ in walls)} s, predict {' + '.join(f'{p:.2f}' for _, p in walls)} s) "
          f"[{card}]", flush=True)
    return {"gene": gene, "arch": arch, "launches": counts, "wall_s": wall,
            "draft_annotation": results[1][0]}


MESH_SHAPES = ((2, 2), (1, 4))  # (data, model) over four slots

MULTIHOST_WORKER = r"""
import glob, json, os, sys, time

rank, port, inputs, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
import torch
import torch.distributed as dist

from kaptive_tpu_torch.db import Database
from kaptive_tpu_torch.parallel.multihost import ShardedJsonlWriter, initialize_distributed, shard_inputs
from kaptive_tpu_torch.serotyping import Serotyper

t0 = time.perf_counter()
assert initialize_distributed("127.0.0.1:%s" % port, 2, rank)
assert (dist.get_rank(), dist.get_world_size()) == (rank, 2)
db = Database.from_genbank(glob.glob(os.path.join(inputs, "*.gbk"))[0])
mine = shard_inputs(sorted(glob.glob(os.path.join(inputs, "*.fasta"))))
with ShardedJsonlWriter(os.path.join(outdir, "results.jsonl")) as w:
    for result in Serotyper(db, device="cuda").batch(mine):
        w.write_result(result)
dist.barrier()
dist.destroy_process_group()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kaptive_tpu"))
assert loaded == [], "foreign modules loaded: %s" % loaded
print(json.dumps({"rank": rank, "typed": len(mine), "seconds": time.perf_counter() - t0}), flush=True)
"""


def _multihost_run(card: str, inputs: Path, results) -> list[float]:
    """Two processes on the card meet through ``initialize_distributed`` (gloo) and type their
    ``shard_inputs`` slices; the merged shards must equal the in-process records. Returns walls."""
    import socket
    import subprocess

    from kaptive_tpu_torch.serotyping.cli import result_to_jsonl_bytes

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outdir = inputs / "multihost"
    outdir.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in ("KAPTIVE_SEED_MODE", "KAPTIVE_PROFILE")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", MULTIHOST_WORKER, str(rank), str(port), str(inputs),
                               str(outdir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multi-host worker {rank} exited {p.returncode}:\n{err[-3000:]}")
    reports = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    merged = {}
    for shard in sorted(outdir.glob("results.part-*.jsonl")):
        for line in shard.read_bytes().splitlines(keepends=True):
            merged[json.loads(line)["genome"]] = line
    want = {r.genome: result_to_jsonl_bytes(r) for r in results}
    if merged != want:
        raise AssertionError(f"two-process records differ from the in-process records: "
                             f"{sorted(set(merged) ^ set(want)) or [g for g in want if merged.get(g) != want[g]]}")
    typed = ", ".join(str(r["typed"]) for r in reports)
    each = ", ".join(f"{r['seconds']:.3f}" for r in reports)
    print(f"# two processes on the card (gloo, 127.0.0.1): {typed} assemblies typed; merged JSONL shards == "
          f"in-process records on {len(want)}/{len(want)}; {wall:.3f} s wall for both (each {each} s from its "
          f"group join to its exit, database load included); no jax or kaptive_tpu module in either [{card}]",
          flush=True)
    return [r["seconds"] for r in reports]


def mesh_phase(card: str, db, assemblies, results, inputs: Path) -> dict:
    """Step 11: typing, screen and multi-host scaffolding on a four-slot mesh. Returns the launches
    and the checks of one recorded shard call of the fill and traceback and one of the scan."""
    import numpy as np
    import torch

    from kaptive_tpu_torch.ops import mapper, swg
    from kaptive_tpu_torch.parallel import make_mesh
    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.parallel.screen import sharded_locus_screen
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.serotyping.io import KaptiveRow
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    slots = [torch.device("cuda", i % torch.cuda.device_count()) for i in range(4)]
    want = [bytes(KaptiveRow.from_result(r)) for r in results]
    kernels = ("scan.cuda.rowcompact", "swg.cuda.fill", "swg.cuda.traceback")
    launches = dict.fromkeys(kernels, 0)
    buckets, scans = _CallRecorder(swg.banded_swg), _CallRecorder(mapper.rowcompact_scan)
    for data, model in MESH_SHAPES:
        serotyper = Serotyper(db, mesh=make_mesh(devices=slots, model_parallel=model))
        _, prime_s = type_all(serotyper, assemblies, BATCH_SIZE)
        reset_metrics()
        swg.banded_swg, mapper.rowcompact_scan = buckets, scans  # each shard's calls
        try:
            got, wall = type_all(serotyper, assemblies, BATCH_SIZE)
        finally:
            swg.banded_swg, mapper.rowcompact_scan = buckets.inner, scans.inner
        counts = snapshot()
        if [bytes(KaptiveRow.from_result(r)) for r in got] != want:
            raise AssertionError(f"mesh ({data}, {model}): rows differ from the single-card host-seeded rows")
        if min(counts.get(k, 0) for k in kernels) == 0 or any(".plain." in k for k in counts):
            raise AssertionError(f"mesh ({data}, {model}) did not run on the kernels alone: {counts}")
        for k in kernels:
            launches[k] += counts[k]
        print(f"# mesh ({data}, {model}) over {[str(d) for d in slots]}: {len(got)}/{len(got)} correct, rows == "
              f"step 3's; priming pass {prime_s:.3f} s, measured pass {wall:.3f} s wall "
              f"({len(got) / wall:.3f} asm/s); launches {({k: counts[k] for k in kernels})}, "
              f"device-chained {counts.get('map.device_chained', 0)}, host fall-backs "
              f"{ {k: v for k, v in counts.items() if k.startswith('map.host_fallback')} } [{card}]", flush=True)
    # The shards' own shapes: the largest extension shard and the largest data row's scan.
    shard = buckets.largest_bucket(4)
    if shard is None or not scans.calls:
        raise AssertionError("no extension shard or row scan was recorded in the mesh passes")
    checks = {"bucket": _check_bucket("mesh extension shard", *shard, "warp"),
              "scan": _check_scan(*max((args for args, _ in scans.calls), key=lambda args: args[0].numel()))}
    del buckets, scans, shard

    streams = [_named_stream(name, fasta) for name, *_, fasta in assemblies]
    genomes, best_one, weighted_one = Serotyper(db, device="cuda").screen(streams)
    codes = encode_assemblies_to_batch(genomes)
    tables = ScreenTables.build(db, db.gene_index)
    _, _, tallies_one = locus_screen_batch(torch.from_numpy(codes).cuda(), tables, len(db.genes))
    for data, model in MESH_SHAPES:
        mesh = make_mesh(devices=slots, model_parallel=model)
        reset_metrics()
        _, best, weighted = Serotyper(db, mesh=mesh).screen([_named_stream(a[0], a[3]) for a in assemblies])
        counts = snapshot()
        best_m, weighted_m, tallies_m = sharded_locus_screen(mesh, codes, tables)
        if counts.get("scan.cuda.rowcompact", 0) == 0 or any(".plain." in k for k in counts):
            raise AssertionError(f"sharded screen ({data}, {model}) did not scan on the kernel: {counts}")
        if not (np.array_equal(best, best_one) and torch.equal(tallies_m.cpu(), tallies_one.cpu())
                and np.array_equal(best_m.cpu().numpy(), best_one)):
            raise AssertionError(f"sharded screen ({data}, {model}) differs from one card's in best or tallies")
        if not (np.allclose(weighted, weighted_one, rtol=1e-6, atol=0)
                and np.allclose(weighted_m.cpu().numpy(), weighted_one, rtol=1e-6, atol=0)):
            raise AssertionError(f"sharded screen ({data}, {model}) differs in weighted beyond rtol=1e-6")
    print(f"# sharded screen on {MESH_SHAPES}: best and tallies == one card's, weighted within rtol 1e-6; "
          f"scan kernel only", flush=True)

    _multihost_run(card, inputs, results)
    return {"launches": launches, **checks}


# The installed ``type``: runs the command line and reports, after it, what it loaded and built.
INSTALLED_RUN = r"""
import atexit, json, sys


@atexit.register
def _report():
    import kaptive_tpu_torch
    from kaptive_tpu_torch.native import hostio
    from kaptive_tpu_torch.ops import scan_cuda, swg_cuda, viterbi_cuda

    sys.stderr.write("\nINSTALL=" + json.dumps({
        "package": kaptive_tpu_torch.__file__,
        "sources": [str(hostio.SOURCE)] + [str(m.LIBRARY.source) for m in (scan_cuda, swg_cuda, viterbi_cuda)],
        "libraries": [str(hostio.LIBRARY)] + [str(m.LIBRARY.library) for m in (scan_cuda, swg_cuda, viterbi_cuda)],
        "foreign": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "kaptive_tpu")),
    }) + "\n")


sys.argv = ["kaptive-tpu-torch", *sys.argv[1:]]
from kaptive_tpu_torch.cli import main

main()
"""


def _install_port(tmp: Path) -> tuple[Path, str]:
    """Step 12 (a): a wheel of the repository's packages, built offline from a copy of them
    (so nothing is written into the checkout) and installed with ``--target`` into ``tmp/site``;
    where setuptools is missing, the tree that wheel would hold is copied there instead.
    Returns ``(site, what was done)``."""
    import importlib.util
    import shutil
    import subprocess
    import zipfile

    site, src = tmp / "site", tmp / "src"
    skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.tmp")
    if importlib.util.find_spec("setuptools") is None:
        shutil.copytree(ROOT / "kaptive_tpu_torch", site / "kaptive_tpu_torch", ignore=skip)
        return site, "setuptools is missing: copied the tree the wheel would hold (the .py files and csrc/)"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(ROOT / name, src / name)
    for pkg in ("kaptive_tpu", "kaptive_tpu_torch"):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=skip)
    def pip(*args):
        proc = subprocess.run([sys.executable, "-m", "pip", *args, "--no-deps", "--no-index", "-q"], cwd=tmp,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"pip {args[0]} failed ({proc.returncode}):\n{proc.stderr[-3000:]}")

    t0 = time.perf_counter()
    pip("wheel", str(src), "--no-build-isolation", "-w", str(tmp / "wheel"))
    (wheel,) = (tmp / "wheel").glob("*.whl")
    pip("install", "--target", str(site), str(wheel))

    shipped = sorted(n for n in zipfile.ZipFile(wheel).namelist() if "/csrc/" in n)
    sources = sorted(f"kaptive_tpu_torch/csrc/{p.name}" for p in (ROOT / "kaptive_tpu_torch" / "csrc").iterdir()
                     if p.suffix in (".cu", ".cpp"))
    if shipped != sources:
        raise AssertionError(f"the wheel ships {shipped}, not every kernel source {sources}")
    return site, (f"built {wheel.name} offline (pip wheel --no-build-isolation) and installed it with "
                  f"--target in {time.perf_counter() - t0:.1f} s; it ships {', '.join(Path(n).name for n in shipped)}")


def install_phase(card: str, inputs: Path, assemblies, results) -> dict:
    """Step 12 (a, b): the port as users install it; ``type`` from the installed package, outside
    the checkout, host- and device-seeded. Returns the wall seconds per mode."""
    import subprocess

    from kaptive_tpu_torch.serotyping.io import KaptiveRow

    want = KaptiveRow.header() + b"".join(bytes(KaptiveRow.from_result(r)) for r in results)
    checkout_build = ROOT / "build"

    def build_listing():
        return sorted((str(p), p.stat().st_mtime_ns) for p in checkout_build.rglob("*")) if checkout_build.exists() else []

    before = build_listing()
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        site, how = _install_port(tmp)
        print(f"# installed port: {how}", flush=True)
        cache = tmp / "cache"
        env = {k: v for k, v in os.environ.items() if k not in ("KAPTIVE_SEED_MODE", "KAPTIVE_PROFILE", "PYTHONPATH")}
        env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(cache))
        gbk = next(inputs.glob("*.gbk"))
        fastas = [str(inputs / f"{name}.fasta") for name, *_ in assemblies]
        for mode in ("host", "device"):
            cwd = tmp / f"run_{mode}"
            cwd.mkdir()
            cmd = [sys.executable, "-c", INSTALLED_RUN, "type", str(gbk), *fastas, "-o", "out.tsv",
                   "--batch-size", str(BATCH_SIZE), "--device", "cuda", "--seed-mode", mode, "--profile"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, timeout=900)
            walls[mode] = time.perf_counter() - t0
            err = proc.stderr.decode()
            if proc.returncode != 0:
                raise AssertionError(f"installed type --seed-mode {mode} exited {proc.returncode}:\n{err[-3000:]}")
            (line,) = [ln for ln in err.splitlines() if ln.startswith("INSTALL=")]
            report = json.loads(line.removeprefix("INSTALL="))
            package = site / "kaptive_tpu_torch"
            if Path(report["package"]) != package / "__init__.py":
                raise AssertionError(f"the installed run imported {report['package']}, not {package}")
            if report["foreign"]:
                raise AssertionError(f"the installed run loaded {report['foreign']}")
            if any(Path(src).parent != package / "csrc" for src in report["sources"]):
                raise AssertionError(f"sources outside the installed package: {report['sources']}")
            if any(Path(lib).parent != cache / "kaptive_tpu_torch" for lib in report["libraries"]):
                raise AssertionError(f"libraries outside the user cache: {report['libraries']}")
            if (cwd / "out.tsv").read_bytes() != want:
                raise AssertionError(f"installed type --seed-mode {mode}: TSV differs from step 3's rows")
            counts = _counters(err)
            kernels = ["swg.cuda.fill", "swg.cuda.traceback"] + (["scan.cuda.rowcompact"] if mode == "device" else [])
            if min(counts.get(k, 0) for k in kernels) == 0 or any(k.split(".")[1] == "plain" for k in counts):
                raise AssertionError(f"installed type --seed-mode {mode} did not run on the kernels: {counts}")
            built = sorted(p.name for p in (cache / "kaptive_tpu_torch").glob("*.so"))
            print(f"# installed `type`, {mode}-seeded, cwd outside the checkout: {len(assemblies)} assemblies in "
                  f"{walls[mode]:.3f} s wall (its builds included) [{card}]; TSV == step 3's rows; no jax or "
                  f"kaptive_tpu module; libraries in the fresh user cache: {built}; counters "
                  f"{ {k: v for k, v in sorted(counts.items()) if k.startswith(('swg.', 'scan.'))} }", flush=True)
        for lib in ("libkaptive_hostio.so", "libkaptive_swg.so", "libkaptive_scan.so"):
            if not (cache / "kaptive_tpu_torch" / lib).is_file():
                raise AssertionError(f"{lib} was not built in the user cache")
    if build_listing() != before:
        raise AssertionError("the installed runs wrote under the checkout's build/")
    print("# nothing new under the checkout's build/", flush=True)
    return walls


def _flat_bound(n_positions: int) -> dict:
    """The flat scan's bound: a code read, and selected, an 8-byte hash and a strand written,
    a position (11 bytes); ~35 integer operations a position."""
    return _bound(11 * n_positions, SCAN_OPS_PER_POSITION * n_positions)


def _check_flat_scan(codes, k: int = 15, w: int = 10) -> dict:
    """Flat-scan kernel vs plain version (both on the card) on a (B, L) batch: exact on all three
    outputs; returns the kernel's, the front door's and the plain form's times and the largest
    difference."""
    import torch

    from kaptive_tpu_torch.ops.minimizer import minimizer_scan
    from kaptive_tpu_torch.ops.scan import minimizer_scan_plain
    from kaptive_tpu_torch.ops.scan_cuda import minimizer_scan_cuda

    got = minimizer_scan_cuda(codes, k, w)
    want = minimizer_scan_plain(codes, k, w)
    torch.cuda.synchronize()
    if any(g.shape != p.shape or g.dtype != p.dtype for g, p in zip(got, want)):
        raise AssertionError("flat scan: kernel and plain outputs differ in shape or dtype")
    max_err = max(int((g.long() - p.long()).abs().max()) for g, p in zip(got, want))
    if max_err != 0:
        raise AssertionError(f"flat scan: kernel and plain version differ (max |diff| {max_err})")
    n_sel = int(want[0].sum())
    del got, want
    times = {"ms": _timed(lambda: minimizer_scan_cuda(codes, k, w), 20),
             "front_door_ms": _timed(lambda: minimizer_scan(codes, k, w), 20),
             "plain_ms": _timed(lambda: minimizer_scan_plain(codes, k, w), 2)}
    times.update(_flat_bound(codes.numel()))
    return {"max_abs_err": max_err, "shape": tuple(codes.shape), "selected": n_sel, **times}


def flat_scan_phase(card: str, db, assemblies) -> dict:
    """Step 12 (c, d, e): the flat-scan kernel held to its plain form, screen mode's overflow
    branch on the kernel, and the one-contig architectural Viterbi held to its plain form."""
    import numpy as np
    import torch
    from scan_panels import poly_a
    from viterbi_panels import arch_panel

    from kaptive_tpu_torch.bgc.kernels import architectural_viterbi
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops import scan_cuda
    from kaptive_tpu_torch.ops.minimizer import DEFAULT_W
    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    # (c) Step 3's four largest assemblies as one (4, L) stream, and the poly-A overflow panel.
    largest = sorted(assemblies, key=lambda a: -len(a[3]))[:4]
    genomes = [GenomeAssembly.from_stream(_named_stream(name, fasta), name) for name, *_, fasta in largest]
    codes = torch.from_numpy(encode_assemblies_to_batch(genomes)).cuda()
    flat = _check_flat_scan(codes)
    panel = _check_flat_scan(torch.from_numpy(poly_a(np.random.default_rng(SEED))).cuda()[None])
    print(f"# flat scan (B, L) = {flat['shape']}, {flat['shape'][0] * flat['shape'][1]:,} positions, "
          f"{flat['selected']:,} selected: kernel == plain on selected, hashes, strands; kernel {flat['ms']:.4f} ms, "
          f"front door (minimizer_scan) {flat['front_door_ms']:.4f} ms, plain {flat['plain_ms']:.4f} ms (on the "
          f"card); bound {flat['bound_ms']:.4f} ms by {flat['bound_by']}: the kernel runs at {_share(flat)} "
          f"[{card}]; poly-A panel {panel['shape']}: kernel == plain, {panel['selected']} selected", flush=True)
    w10 = [e for e in scan_cuda.LIBRARY.ptxas_report().split(" | ") if e.startswith(f"minimizer_scan_kernel<{DEFAULT_W}>")]
    print(f"# ptxas, the flat scan's w = {DEFAULT_W} instance: {w10}", flush=True)
    del codes
    torch.cuda.empty_cache()

    # (d) Screen mode on a batch with one overflowing assembly (a 400-base poly-A run in its first contig).
    name, truth, kind, fasta = assemblies[0]
    head, _, rest = fasta.partition(b"\n")
    batch = [(f"{name}_polyA", head + b"\n" + rest[:4] + b"A" * 400 + rest[4:])]
    batch += [(a[0], a[3]) for a in assemblies[1:4]]
    serotyper = Serotyper(db, device="cuda")
    serotyper.screen([_named_stream(n, f) for n, f in batch])  # priming: tables to the card
    reset_metrics()
    screened, best, weighted = serotyper.screen([_named_stream(n, f) for n, f in batch])
    counts = snapshot()
    launches = counts.get("scan.cuda.flat", 0)
    if counts.get("screen.overflow") != 1 or launches != 1 or any(k.startswith("scan.plain") for k in counts):
        raise AssertionError(f"the overflow branch did not run on the flat-scan kernel: {counts}")
    codes = torch.from_numpy(encode_assemblies_to_batch(screened))
    tables = ScreenTables.from_database(db)
    best_c, _, tallies_c = locus_screen_batch(codes.cuda(), tables, len(db.genes))
    t0 = time.perf_counter()
    best_p, weighted_p, tallies_p = locus_screen_batch(codes, tables, len(db.genes))
    cpu_s = time.perf_counter() - t0
    if not (torch.equal(tallies_c.cpu(), tallies_p) and torch.equal(best_c.cpu(), best_p)
            and np.array_equal(best, best_p.numpy())):
        raise AssertionError("the overflowing screen differs between the card and the CPU")
    if not np.allclose(weighted, weighted_p.numpy(), rtol=1e-6, atol=0):
        raise AssertionError("the overflowing screen's weighted scores differ beyond rtol=1e-6")
    print(f"# screen with an overflowing assembly ({len(batch)} assemblies, codes {tuple(codes.shape)}): "
          f"screen.overflow 1, scan.cuda.flat {launches}, no plain scan; card == CPU (tallies, best exact, "
          f"weighted rtol 1e-6; CPU screen {cpu_s:.2f} s); best {[db.loci.ids[int(b)] for b in best]}", flush=True)

    # (e) The one-contig architectural Viterbi front door, at the clean assembly's ORF count.
    em, trans, _ = arch_panel(np.random.default_rng(SEED), [24438], 28)
    reset_metrics()
    path, score = architectural_viterbi(em, trans)
    torch.cuda.synchronize()
    arch_counts = snapshot()
    want_path, want_score = architectural_viterbi(em, trans, device="cpu")
    if arch_counts != {"viterbi.cuda.arch": 1} or not (torch.equal(path.cpu(), want_path)
                                                       and torch.equal(score.cpu(), want_score)):
        raise AssertionError(f"architectural_viterbi on the card differs from its plain form ({arch_counts})")
    print(f"# architectural_viterbi, one contig of {em.shape[0]} rows x {em.shape[1]} states: one "
          f"arch_viterbi_kernel launch, path and score == the plain form's (score {score.item():.4f})", flush=True)
    return {**flat, "launches": launches, "panel_max_abs_err": panel["max_abs_err"]}


def blosum_x20_align_args(n_pairs: int = 48, seed: int = SEED) -> tuple:
    """``batched_swg_align``'s arguments for step 12(f)'s F8: ``n_pairs`` unseeded protein pairs of
    80-400 residues (targets: the query with 10% substitutions behind up to 60 random residues)
    scored with BLOSUM62 x 20 and gaps 220 + 20."""
    import numpy as np
    from range_panels import scaled_blosum
    from swg_panels import AA

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(AA, np.uint8)
    qs = [alpha[rng.integers(0, 20, int(rng.integers(80, 400)))] for _ in range(n_pairs)]
    ts = []
    for q_seq in qs:
        t_seq = q_seq.copy()
        t_seq[rng.random(len(t_seq)) < 0.1] = alpha[rng.integers(0, 20)]
        ts.append(np.concatenate([alpha[rng.integers(0, 20, int(rng.integers(0, 60)))], t_seq]))

    def ragged(xs):
        lengths = np.array([len(x) for x in xs], np.int32)
        return np.concatenate(xs), np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64), lengths

    q_r, t_r = ragged(qs), ragged(ts)
    k_locals = np.maximum(20, np.abs(q_r[2] - t_r[2]) + 1).astype(np.int32)
    return (*q_r, *t_r, np.zeros(n_pairs, np.int32), k_locals, scaled_blosum(20), 220, 20)


def record_f7_bucket():
    """The unseeded F7 pair through the default ``PairwiseAligner`` with the fill's front door
    recorded: ``(SwgResult, counts, (args, kw) of its one bucket)``."""
    from range_panels import f7_pair

    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.core.pairwise import PairwiseAligner
    from kaptive_tpu_torch.core.seq import Sequences

    query, target = f7_pair()
    recorder = _CallRecorder(pairwise.banded_swg)
    pairwise.banded_swg = recorder
    try:
        res = PairwiseAligner()(Sequences.from_bytes([query]), Sequences.from_bytes([target]))
    finally:
        pairwise.banded_swg = recorder.inner
    return res, recorder.calls[0]


def train_arch_257(db):
    """A 254-archetype model (257 states) trained on the database's KL loci: ``(model, seconds)``."""
    from kaptive_tpu_torch.bgc import ArchitecturalTrainer

    t0 = time.perf_counter()
    loci = [db.get_locus_data(name) for name in db.loci.ids if name.startswith("KL")]
    model = ArchitecturalTrainer(num_archetypes=254, feature_dim=64).train(loci)
    return model, time.perf_counter() - t0


def record_arch_predict(model, annotation):
    """``ArchitecturalPredictor(model).predict(annotation)`` on the card with the decode's front
    door recorded: ``(predicted, [(args, kw)] of its launches)``."""
    from kaptive_tpu_torch.bgc import ArchitecturalPredictor
    from kaptive_tpu_torch.bgc import kernels as bgc_kernels

    arch_rec = _CallRecorder(bgc_kernels.arch_viterbi)
    bgc_kernels.arch_viterbi = arch_rec
    try:
        predicted = ArchitecturalPredictor(model, device="cuda").predict(annotation)
    finally:
        bgc_kernels.arch_viterbi = arch_rec.inner
    return predicted, arch_rec.calls


def input_range_phase(card: str, db, assemblies, draft_annotation) -> dict:
    """Step 12 (f): the kernel forms of the inputs the main path's forms refuse: the fill's
    cluster form (w_pad 32,768, int32 scores) and segmented form (past the largest cluster), both
    scans' run-time form (k > 16, w > 32) and the architectural decode's block-a-contig form
    (257 states), each through a public entry point, then held to its plain form on the card and
    timed beside its bound."""
    import numpy as np
    import torch
    from range_panels import F7_EXPECTED, f7_pair, scaled_blosum, scan_stream, wide_band_panel
    from swg_panels import NT, nt_matrix

    from kaptive_tpu_torch.bgc import ArchitecturalPredictor
    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.core.pairwise import batched_swg_align, batched_swg_align_cigars
    from kaptive_tpu_torch.ops import mapper
    from kaptive_tpu_torch.ops.swg import banded_swg
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, cluster_plan
    from kaptive_tpu_torch.ops.mapper import GeneIndex, map_genes_batch
    from kaptive_tpu_torch.ops.minimizer import build_minimizer_set, minimizer_scan
    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any, rowcompact_scan
    from kaptive_tpu_torch.ops.scan_cuda import build as scan_build
    from kaptive_tpu_torch.ops.viterbi import arch_viterbi_plain
    from kaptive_tpu_torch.ops.viterbi_cuda import arch_viterbi_cuda
    from kaptive_tpu_torch.ops.viterbi_cuda import build as viterbi_build
    from kaptive_tpu_torch.parallel.screen import encode_assemblies_to_batch
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    t_phase = time.perf_counter()
    launches = {}

    def drive(label: str, fn, want: dict):
        """``fn()`` with the counts set to 0 just before and read just after; every counter of
        ``want`` must have launched, and no plain form may run."""
        reset_metrics()
        out = fn()
        torch.cuda.synchronize()
        counts = snapshot()
        if any(counts.get(k, 0) < 1 for k in want) or any(".plain." in k for k in counts):
            raise AssertionError(f"{label} did not run on the kernels {sorted(want)} alone: {counts}")
        for k in want:
            launches[k] = launches.get(k, 0) + counts[k]
        return out, counts

    # F7: the unseeded 150-versus-4,300 pair through the default aligner (the w_pad 32,768 bucket).
    query, target = f7_pair()
    (res, f7_call), counts = drive("the F7 pair", record_f7_bucket, {"swg.cuda.fill_cluster", "swg.cuda.traceback"})
    got = {field: int(getattr(res, field)[0]) for field in F7_EXPECTED}
    if got != F7_EXPECTED:
        raise AssertionError(f"the F7 pair on the card: {got}, the JAX package gives {F7_EXPECTED}")
    seqs = [np.frombuffer(x, np.uint8) for x in (query, target)]
    (_, cigars), _ = drive("the F7 pair's CIGAR", lambda: batched_swg_align_cigars(
        seqs[0], np.zeros(1, np.int64), np.array([len(query)], np.int32), seqs[1], np.zeros(1, np.int64),
        np.array([len(target)], np.int32), np.zeros(1, np.int32), np.array([len(target) - len(query) + 1], np.int32),
        np.asarray(pairwise.blosum62_matrix(), np.int32), 11, 1), {"swg.cuda.fill_cluster", "swg.cuda.traceback_cigar"})
    if cigars.data.tolist() != [len(query) << 4]:
        raise AssertionError(f"the F7 pair's CIGAR on the card: {cigars.data.tolist()}, not one {len(query)}M run")
    print(f"# input range, F7: PairwiseAligner() on the card, the unseeded {len(query)}-versus-{len(target)} protein "
          f"pair: {got} (the JAX package's values), CIGAR {len(query)}M; counts {dict(sorted(counts.items()))}",
          flush=True)
    f7 = _check_bucket("input range, F7", *f7_call, "cluster")
    print(f"# input range, F7 bucket {f7['shape']} in the cluster form {cluster_plan(f7['shape'][2])} (CTAs, lanes a "
          f"CTA, lanes a thread, threads): fill {f7['fill_ms']:.4f} ms, bound {f7['fill_bound']['bound_ms']:.5f} ms: "
          f"{_share({'ms': f7['fill_ms'], **f7['fill_bound']})} [{card}]", flush=True)

    # F8: scores outside int8 (BLOSUM62 x 20, gap 220 + 20) through batched_swg_align, card == CPU.
    align_args = blosum_x20_align_args()
    recorder = _CallRecorder(pairwise.banded_swg)
    pairwise.banded_swg = recorder
    try:
        on_card, _ = drive("BLOSUM62 x 20", lambda: batched_swg_align(*align_args),
                           {"swg.cuda.fill_cluster", "swg.cuda.traceback"})
    finally:
        pairwise.banded_swg = recorder.inner
    on_cpu = batched_swg_align(*align_args, device="cpu")
    for field in ("scores", "matches", "mismatches", "gaps", "q_starts", "q_ends", "t_starts", "t_ends"):
        if not np.array_equal(getattr(on_card, field), getattr(on_cpu, field)):
            raise AssertionError(f"BLOSUM62 x 20: {field} differs between the card and the CPU")
    print(f"# input range, F8: batched_swg_align with BLOSUM62 x 20 (scores {int(scaled_blosum().min())} .. "
          f"{int(scaled_blosum().max())}), 48 unseeded protein pairs in {len(recorder.calls)} buckets: card == CPU "
          f"(every field; best score {int(on_card.scores.max())})", flush=True)
    int32 = _check_bucket("input range, F8 (BLOSUM62 x 20)", *recorder.largest_bucket(), "cluster")
    print(f"# input range, F8 bucket {int32['shape']} in the cluster form {cluster_plan(int32['shape'][2])}: fill "
          f"{int32['fill_ms']:.4f} ms, bound {int32['fill_bound']['bound_ms']:.5f} ms: "
          f"{_share({'ms': int32['fill_ms'], **int32['fill_bound']})} [{card}]", flush=True)

    # F11: a band past the cluster form's largest (16 CTAs of 8,192 lanes) takes the segmented form.
    w_pad = 131075
    seg_arrays = [torch.from_numpy(a).cuda() for a in wide_band_panel(7, NT, 2, 24, w_pad)]
    seg_kw = dict(gap_open=4, gap_extend=2, rows_max=24, w_pad=w_pad, t_pad=w_pad + 2)
    seg_args = (*seg_arrays, as_kernel_matrix(nt_matrix(), torch.device("cuda")))
    seg_res, _ = drive("a band past the largest cluster", lambda: banded_swg(*seg_args, **seg_kw),
                       {"swg.cuda.fill_segmented", "swg.cuda.traceback"})
    if int(seg_res.scores.max()) <= 0:
        raise AssertionError("the band past the largest cluster aligned nothing")
    segmented = _check_bucket("input range, F11 (past the largest cluster)", seg_args, seg_kw, "segmented")

    # F5 + F9: device seeding with a k = 17, w = 40 index (the row-compact scan's run-time form).
    index = GeneIndex.build(db.genes, k=17, w=40)
    names = tuple(str(i) for i in range(len(db.genes)))
    genomes = [GenomeAssembly.from_stream(_named_stream(a[0], a[3]), a[0]) for a in assemblies[:2]]
    scans = _CallRecorder(mapper.rowcompact_scan)
    mapper.rowcompact_scan = scans
    try:
        mapped, _ = drive("device seeding at (17, 40)", lambda: map_genes_batch(
            index, genomes, names, seed_mode="device", device="cuda"), {"scan.cuda.rowcompact_any", "swg.cuda.fill"})
    finally:
        mapper.rowcompact_scan = scans.inner
    if sum(len(a) for a in mapped) == 0:
        raise AssertionError("device seeding at (17, 40) mapped no gene")
    _, counts = drive("build_minimizer_set at (17, 40)", lambda: build_minimizer_set(
        db.genes, k=17, w=40, device=True), {"scan.cuda.flat_any"})
    print(f"# input range, F5 + F9: map_genes_batch device-seeded with a k = 17, w = 40 GeneIndex on "
          f"{len(genomes)} assemblies: {[len(a) for a in mapped]} alignments; build_minimizer_set(k=17, w=40, "
          f"device=True): {counts}", flush=True)
    rowcompact = _check_scan(*max((args for args, _ in scans.calls), key=lambda args: args[0].numel()))
    largest = sorted(assemblies, key=lambda a: -len(a[3]))[:4]
    stream = torch.from_numpy(encode_assemblies_to_batch(
        [GenomeAssembly.from_stream(_named_stream(a[0], a[3]), a[0]) for a in largest])).cuda()
    flat = _check_flat_scan(stream, 17, 40)
    del stream
    print(f"# input range, flat scan at (17, 40) on (B, L) = {flat['shape']}: kernel == plain; kernel "
          f"{flat['ms']:.4f} ms, front door {flat['front_door_ms']:.4f} ms, plain {flat['plain_ms']:.4f} ms; bound "
          f"{flat['bound_ms']:.4f} ms by {flat['bound_by']}: {_share(flat)} [{card}]", flush=True)
    mb = scan_stream(np.random.default_rng(SEED), 8192 * 128)
    mb_padded, mb_flat = torch.from_numpy(pad_codes_for_scan_any(mb))[None].cuda(), torch.from_numpy(mb)[None].cuda()
    far = [_check_scan(mb_padded, 15, 1100), _check_flat_scan(mb_flat, 15, 1100)]
    print(f"# input range, both scans at (15, 1100) on a {len(mb):,}-position stream (windows past the "
          f"1,024-position halo): kernel == plain; row-compact {far[0]['ms']:.4f} ms, flat {far[1]['ms']:.4f} ms "
          f"[{card}]", flush=True)
    # One window past the run-time form's widest: the sparse-table form, through both front doors.
    w_sparse = int(scan_build().kts_scan_any_max_w(15)) + 1
    _, counts = drive(f"both scans at (15, {w_sparse})", lambda: (
        rowcompact_scan(mb_padded, 15, w_sparse), minimizer_scan(mb_flat, 15, w_sparse)),
        {"scan.cuda.rowcompact_sparse", "scan.cuda.flat_sparse"})
    sparse = [_check_scan(mb_padded, 15, w_sparse), _check_flat_scan(mb_flat, 15, w_sparse)]
    print(f"# input range, both scans at (15, {w_sparse}) (one window past the run-time form's widest) on that "
          f"stream, counts {counts}: kernel == plain; row-compact {sparse[0]['ms']:.4f} ms, flat "
          f"{sparse[1]['ms']:.4f} ms [{card}]", flush=True)

    # F6: a 254-archetype model (257 states) on the draft assembly's annotation, card == CPU.
    model, train_s = train_arch_257(db)
    (predicted, arch_calls), _ = drive("the 254-archetype predictor", lambda: record_arch_predict(
        model, draft_annotation), {"viterbi.cuda.arch_wide"})
    _same_predictions(predicted, ArchitecturalPredictor(model, device="cpu").predict(draft_annotation),
                      "the 254-archetype predictor")
    args = max((a for a, _ in arch_calls), key=lambda a: a[0].shape[0])
    longest = int(torch.diff(args[2]).max())
    paths, scores = arch_viterbi_cuda(*args)
    on_cpu = [x.cpu() for x in args]
    (want_p, want_s), plain_s = _cpu_seconds(lambda: arch_viterbi_plain(*on_cpu))
    if not (torch.equal(paths.cpu(), want_p) and torch.equal(scores.cpu(), want_s)):
        raise AssertionError("the architectural decode's block-a-contig form differs from its plain form")
    arch = {"max_abs_err": 0, "ms": _timed(lambda: arch_viterbi_cuda(*args), 5), "plain_ms": plain_s * 1e3,
            **_arch_bound(args[0], args[2])}
    ctas = viterbi_build().kts_arch_wide_cluster(args[0].shape[1], len(args[2]) - 1)
    print(f"# input range, F6: ArchitecturalPredictor of {model.transitions.shape[0] - 3} archetypes (trained in "
          f"{train_s:.1f} s) on the draft assembly's annotation: {len(predicted)} predicted loci, card == CPU; "
          f"the largest decode, {args[0].shape[0]} rows x {args[0].shape[1]} states in {len(args[2]) - 1} contigs "
          f"(the longest {longest} rows; {ctas} CTAs a contig): kernel == plain; kernel {arch['ms']:.4f} ms "
          f"({arch['ms'] * 1e3 / longest:.3f} us a row of the longest), plain (CPU, one thread) "
          f"{arch['plain_ms']:.1f} ms; bound {arch['bound_ms']:.5f} ms by {arch['bound_by']}: {_share(arch)} [{card}]",
          flush=True)
    wall = time.perf_counter() - t_phase
    print(f"# input range phase: {wall:.1f} s wall; launches {launches} [{card}]", flush=True)
    return {"f7": f7, "int32": int32, "segmented": segmented, "rowcompact": rowcompact, "flat": flat, "far": far,
            "sparse": sparse, "w_sparse": w_sparse, "arch": {**arch, "longest_rows": longest}, "launches": launches,
            "wall_s": wall}


def build_workload(n_assemblies: int, seed: int = SEED):
    """bench.py's database (140 loci x 18 genes) and ``n_assemblies`` 5.3 Mb assemblies
    cycling through its composition classes: ``(db, [(name, truth, class, fasta)],
    {file name: bytes} of the database's GenBank and TOML sources)``."""
    import numpy as np

    from bench import GENOME_MB, KINDS, _compose_fasta
    from torch_synthetic import make_synthetic_db

    from kaptive_tpu_torch.db import Database

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
    """``--measure``: full-size synthetic buckets, live-pair steps and scan batches (see the
    module docstring, steps 13 to 15)."""
    import numpy as np
    import torch
    from scan_panels import random_stream
    from swg_panels import AA, NT, nt_matrix

    from kaptive_tpu_torch.core.pairwise import blosum62_matrix
    from kaptive_tpu_torch.ops.minimizer import DEFAULT_K, DEFAULT_W
    from kaptive_tpu_torch.ops.scan import add_halo
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, fill_form, swg_fill_cuda, swg_traceback_cuda

    rng = np.random.default_rng(SEED)
    for alpha, B, rows_max, w_pad in SYNTHETIC_BUCKETS:
        protein = alpha == "aa"
        arrays = _synthetic_bucket(rng, AA if protein else NT, B, rows_max, w_pad)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        matrix = as_kernel_matrix(blosum62_matrix() if protein else nt_matrix(), args[0].device)
        kw = dict(gap_open=11 if protein else 4, gap_extend=1 if protein else 2,
                  rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
        times = _check_bucket(f"synthetic {'protein' if protein else 'extension'}", (*args, matrix), kw,
                              fill_form(w_pad))
        cells = int(arrays[1].astype(np.int64).sum()) * w_pad
        print(f"#   fill: {cells / times['fill_ms'] / 1e6:.2f} G band-cells/s "
              f"(band cells = sum of q_len x w_pad) [{card}]", flush=True)

    # Step 14: one shape, more and more live pairs (the rest of the bucket is empty pairs).
    rows_max, w_pad = 1024, 128
    matrix = as_kernel_matrix(nt_matrix(), torch.device("cuda"))
    fill_kw = dict(gap_open=4, gap_extend=2, rows_max=rows_max, w_pad=w_pad)
    for live in LIVE_PAIR_STEPS:
        B = max(384, live)
        arrays = list(_synthetic_bucket(rng, NT, B, rows_max, w_pad))
        arrays[1][live:] = 0
        arrays[3][live:] = 0
        q, ql, t, tl, off, kl = (torch.from_numpy(a).cuda() for a in arrays)
        tb, *best = swg_fill_cuda(q, ql, t, tl, off, kl, matrix, **fill_kw)
        fill_ms = _timed(lambda: swg_fill_cuda(q, ql, t, tl, off, kl, matrix, **fill_kw), 20)
        walk_ms = _timed(lambda: swg_traceback_cuda(tb, q, t, *best, off, rows_max=rows_max, w_pad=w_pad,
                                                    t_pad=w_pad + 2), 20)
        cells = int(arrays[1].astype(np.int64).sum()) * w_pad
        print(f"# live pairs {live} of {B} at (rows_max, w_pad) = ({rows_max}, {w_pad}): fill {fill_ms:.4f} ms "
              f"({cells / fill_ms / 1e6:.2f} G band-cells/s), traceback {walk_ms:.4f} ms [{card}]", flush=True)

    # Step 15: the scan at more and more genomes in one launch.
    streams = torch.from_numpy(np.stack([random_stream(rng, SCAN_ROWS) for _ in range(max(SCAN_GENOME_STEPS))]))
    for n_genomes in SCAN_GENOME_STEPS:
        times = _check_scan(add_halo(streams[:n_genomes].cuda()), DEFAULT_K, DEFAULT_W)
        print(f"#   scan of {n_genomes} genomes in one launch: {times['ms']:.4f} ms, "
              f"{n_genomes * SCAN_ROWS * 128 / times['ms'] / 1e6:.2f} G positions/s [{card}]", flush=True)
        torch.cuda.empty_cache()


def main() -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--measure", action="store_true",
                        help="after the smoke, also run the measurements of steps 13 to 15")
    opts = parser.parse_args()

    from bench import GENOME_MB, KINDS
    from swg_panels import AA

    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.core.pairwise import blosum62_matrix
    from kaptive_tpu_torch.native import hostio
    from kaptive_tpu_torch.ops import mapper, scan_cuda, swg_cuda, viterbi_cuda
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.serotyping.io import KaptiveRow
    from kaptive_tpu_torch.utils.device import card_info, require_cuda
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.utils.profiling import phase_report, reset_phases

    os.environ["KAPTIVE_PROFILE"] = "1"
    os.environ["KAPTIVE_SEED_MODE"] = "host"  # steps 3-5; step 6 is device-seeded
    require_cuda()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:  # one compiler per source, all started together
        for build in [pool.submit(fn) for fn in (swg_cuda.build, scan_cuda.build, viterbi_cuda.build, hostio.load)]:
            build.result()
    build_s = time.perf_counter() - t0
    print(f"# builds of csrc/swg.cu, csrc/scan.cu, csrc/viterbi.cu (nvcc) and csrc/hostio.cpp (g++), in parallel, "
          f"into {swg_cuda.LIBRARY.library.parent.relative_to(ROOT)}/: {build_s:.1f} s", flush=True)
    for m in (swg_cuda, scan_cuda, viterbi_cuda):
        print(f"# ptxas {m.LIBRARY.source.name}: {m.LIBRARY.ptxas_report()}", flush=True)

    t0 = time.perf_counter()
    db, assemblies, sources = build_workload(N_ASSEMBLIES)
    serotyper = Serotyper(db, device="cuda")
    print(f"# workload: {len(db.loci)} loci, {len(db.genes)} genes, {N_ASSEMBLIES} x {GENOME_MB} Mb "
          f"assemblies ({'/'.join(KINDS)}); set-up {time.perf_counter() - t0:.1f} s", flush=True)

    _, prime_s = type_all(serotyper, assemblies, BATCH_SIZE)
    print(f"# priming pass: {N_ASSEMBLIES}/{N_ASSEMBLIES} correct in {prime_s:.2f} s", flush=True)

    recorder = _CallRecorder(pairwise.banded_swg)
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
        largest = recorder.largest_bucket(gap_open)
        if largest is None:
            raise AssertionError(f"no {label} bucket was recorded in the measured pass")
        args, kw = largest
        checks[label] = _check_bucket(label, args, kw, "warp")
    # The wide form of the fill (bands a warp cannot hold): synthetic protein pairs.
    B, rows_max, w_pad = WIDE_FORM_BUCKET
    wide_args = [torch.from_numpy(a).cuda()
                 for a in _synthetic_bucket(np.random.default_rng(SEED), AA, B, rows_max, w_pad)]
    wide_matrix = swg_cuda.as_kernel_matrix(blosum62_matrix(), wide_args[0].device)
    checks["wide"] = _check_bucket(
        "synthetic wide-form", (*wide_args, wide_matrix),
        dict(gap_open=11, gap_extend=1, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2), "wide")

    # Device-seeded mode on the same assemblies: its own priming and measured pass.
    os.environ["KAPTIVE_SEED_MODE"] = "device"
    _, prime_s = type_all(serotyper, assemblies, BATCH_SIZE)
    print(f"# device-seeded priming pass: {N_ASSEMBLIES}/{N_ASSEMBLIES} correct in {prime_s:.2f} s", flush=True)
    scans = _CallRecorder(mapper.rowcompact_scan)
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
    if not scans.calls:
        raise AssertionError("no scan batch was recorded in the device-seeded pass")
    scan_check = _check_scan(*max((args for args, _ in scans.calls), key=lambda args: args[0].numel()))

    with tempfile.TemporaryDirectory() as inputs:  # steps 7 and 11 read the same files
        inputs = Path(inputs)
        write_inputs(inputs, sources, assemblies)
        cli_walls = cli_phase(card, inputs, assemblies, results)
        screen_rate = screen_phase(card, db, assemblies)
        cigar_check, cigar_launches = cigar_phase(serotyper, db, assemblies)
        bgc = bgc_phase(card, db, assemblies)
        mesh = mesh_phase(card, db, assemblies, results, inputs)
        install_walls = install_phase(card, inputs, assemblies, results)
        flat = flat_scan_phase(card, db, assemblies)
        ranged = input_range_phase(card, db, assemblies, bgc.pop("draft_annotation"))

    if opts.measure:
        measure(card)

    for roots, what in ((("jax", "jaxlib"), "jax"), (("kaptive_tpu",), "kaptive_tpu")):
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in roots)
        if loaded:
            raise AssertionError(f"{what} modules were imported: {loaded}")
        print(f"# no {what} module was loaded", flush=True)

    ext, prot, wide = checks["extension"], checks["protein"], checks["wide"]
    gene = bgc["gene"]
    mesh_launches, mesh_bucket, mesh_scan = mesh["launches"], mesh["bucket"], mesh["scan"]
    swg_err = max(ext["max_abs_err"], prot["max_abs_err"], wide["max_abs_err"], mesh_bucket["max_abs_err"])
    mesh_swg = {"mesh_shape": mesh_bucket["shape"], "mesh_max_abs_err": mesh_bucket["max_abs_err"]}
    kernels = [
        {"name": "swg_fill", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg_pallas.py:91", "launches": launches["fill"],
         "max_abs_err": swg_err, "ms": ext["fill_ms"], "plain_ms": ext["fill_plain_ms"],
         **ext["fill_bound"], "library_ms": None, "mesh_launches": mesh_launches["swg.cuda.fill"], **mesh_swg,
         "protein_ms": prot["fill_ms"], "protein_plain_ms": prot["fill_plain_ms"],
         "protein_bound_ms": prot["fill_bound"]["bound_ms"],
         "wide_form_ms": wide["fill_ms"], "wide_form_plain_ms": wide["fill_plain_ms"],
         "wide_form_bound_ms": wide["fill_bound"]["bound_ms"]},
        {"name": "swg_traceback", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg.py:324", "launches": launches["traceback"],
         "max_abs_err": swg_err, "ms": ext["traceback_ms"], "plain_ms": ext["traceback_plain_ms"],
         **ext["traceback_bound"], "library_ms": None, "mesh_launches": mesh_launches["swg.cuda.traceback"], **mesh_swg,
         "protein_ms": prot["traceback_ms"], "protein_plain_ms": prot["traceback_plain_ms"],
         "protein_bound_ms": prot["traceback_bound"]["bound_ms"]},
        {"name": "rowcompact_scan", "route": "cuda", "source": "kaptive_tpu_torch/csrc/scan.cu",
         "replaces": "kaptive_tpu/ops/scan_pallas.py:230", "launches": scan_launches,
         "max_abs_err": max(scan_check["max_abs_err"], mesh_scan["max_abs_err"]), "ms": scan_check["ms"],
         "plain_ms": scan_check["plain_ms"], "bound_ms": scan_check["bound_ms"], "bound_by": scan_check["bound_by"],
         "library_ms": None, "mesh_launches": mesh_launches["scan.cuda.rowcompact"],
         "mesh_shape": mesh_scan["shape"], "mesh_max_abs_err": mesh_scan["max_abs_err"],
         "flat_scan_ms": flat["ms"], "flat_scan_bound_ms": flat["bound_ms"],
         "flat_scan_max_abs_err": max(flat["max_abs_err"], flat["panel_max_abs_err"])},
        {"name": "minimizer_scan", "route": "cuda", "source": "kaptive_tpu_torch/csrc/scan.cu",
         "replaces": "kaptive_tpu/ops/minimizer.py:146", "launches": flat["launches"],
         "max_abs_err": max(flat["max_abs_err"], flat["panel_max_abs_err"]), "ms": flat["ms"],
         "plain_ms": flat["plain_ms"], "bound_ms": flat["bound_ms"], "bound_by": flat["bound_by"],
         "library_ms": None, "front_door_ms": flat["front_door_ms"], "shape": flat["shape"]},
        {"name": "swg_traceback_cigar", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg.py:526", "launches": cigar_launches,
         "max_abs_err": cigar_check["max_abs_err"], "ms": cigar_check["ms"], "plain_ms": cigar_check["plain_ms"],
         "bound_ms": cigar_check["bound_ms"], "bound_by": cigar_check["bound_by"], "library_ms": None,
         "planted_ms": cigar_check["planted_ms"]},
        {"name": "gene_viterbi", "route": "cuda", "source": "kaptive_tpu_torch/csrc/viterbi.cu",
         "replaces": "kaptive_tpu/bgc/genefinder.py:133", "launches": bgc["launches"]["viterbi.cuda.gene"],
         "max_abs_err": max(g["max_abs_err"] for g in gene.values()), "ms": gene["clean"]["ms"],
         "plain_ms": gene["clean"]["plain_ms"], "bound_ms": gene["clean"]["bound_ms"],
         "bound_by": gene["clean"]["bound_by"], "library_ms": None, "draft_ms": gene["draft"]["ms"],
         "draft_plain_ms": gene["draft"]["plain_ms"], "draft_bound_ms": gene["draft"]["bound_ms"],
         **{f"{key}_{field}": gene[key]["stats"]._asdict()[field]
            for key in ("clean", "draft", "windows") for field in ("chunks", "rounds", "reruns", "filled")}},
        {"name": "arch_viterbi", "route": "cuda", "source": "kaptive_tpu_torch/csrc/viterbi.cu",
         "replaces": "kaptive_tpu/bgc/kernels.py:83", "launches": bgc["launches"]["viterbi.cuda.arch"],
         "max_abs_err": bgc["arch"]["max_abs_err"], "ms": bgc["arch"]["ms"], "plain_ms": bgc["arch"]["plain_ms"],
         "bound_ms": bgc["arch"]["bound_ms"], "bound_by": bgc["arch"]["bound_by"], "library_ms": None},
    ]
    # Step 12 (f)'s forms: launches are the input-range phase's, ms the F7 bucket / the recorded scan
    # batch / the four-assembly flat stream / the largest 257-state decode.
    f7, i32, rc_any, flat_any, arch_w = ranged["f7"], ranged["int32"], ranged["rowcompact"], ranged["flat"], ranged["arch"]
    seg = ranged["segmented"]
    kernels += [
        {"name": "swg_fill_cluster", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg_pallas.py:91", "launches": ranged["launches"]["swg.cuda.fill_cluster"],
         "max_abs_err": max(f7["max_abs_err"], i32["max_abs_err"]), "ms": f7["fill_ms"],
         "plain_ms": f7["fill_plain_ms"], **f7["fill_bound"], "library_ms": None, "shape": f7["shape"],
         "int32_ms": i32["fill_ms"], "int32_plain_ms": i32["fill_plain_ms"],
         "int32_bound_ms": i32["fill_bound"]["bound_ms"], "int32_shape": i32["shape"]},
        {"name": "swg_fill_segmented", "route": "cuda", "source": "kaptive_tpu_torch/csrc/swg.cu",
         "replaces": "kaptive_tpu/ops/swg_pallas.py:91", "launches": ranged["launches"]["swg.cuda.fill_segmented"],
         "max_abs_err": seg["max_abs_err"], "ms": seg["fill_ms"], "plain_ms": seg["fill_plain_ms"],
         **seg["fill_bound"], "library_ms": None, "shape": seg["shape"]},
        {"name": "rowcompact_scan_any", "route": "cuda", "source": "kaptive_tpu_torch/csrc/scan.cu",
         "replaces": "kaptive_tpu/ops/scan_pallas.py:230", "launches": ranged["launches"]["scan.cuda.rowcompact_any"],
         "max_abs_err": max(rc_any["max_abs_err"], ranged["far"][0]["max_abs_err"]), "ms": rc_any["ms"],
         "plain_ms": rc_any["plain_ms"], "bound_ms": rc_any["bound_ms"], "bound_by": rc_any["bound_by"],
         "library_ms": None, "shape": rc_any["shape"], "kw": (17, 40), "w1100_ms": ranged["far"][0]["ms"],
         "w1100_bound_ms": ranged["far"][0]["bound_ms"]},
        {"name": "minimizer_scan_any", "route": "cuda", "source": "kaptive_tpu_torch/csrc/scan.cu",
         "replaces": "kaptive_tpu/ops/minimizer.py:146", "launches": ranged["launches"]["scan.cuda.flat_any"],
         "max_abs_err": max(flat_any["max_abs_err"], ranged["far"][1]["max_abs_err"]), "ms": flat_any["ms"],
         "plain_ms": flat_any["plain_ms"], "bound_ms": flat_any["bound_ms"], "bound_by": flat_any["bound_by"],
         "library_ms": None, "shape": flat_any["shape"], "kw": (17, 40), "w1100_ms": ranged["far"][1]["ms"],
         "w1100_bound_ms": ranged["far"][1]["bound_ms"]},
        *({"name": f"{name}_sparse", "route": "cuda", "source": "kaptive_tpu_torch/csrc/scan.cu",
           "replaces": replaces, "launches": ranged["launches"][f"scan.cuda.{counter}_sparse"],
           "max_abs_err": x["max_abs_err"], "ms": x["ms"], "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
           "bound_by": x["bound_by"], "library_ms": None, "shape": x["shape"], "kw": (15, ranged["w_sparse"])}
          for name, replaces, counter, x in (
              ("rowcompact_scan", "kaptive_tpu/ops/scan_pallas.py:230", "rowcompact", ranged["sparse"][0]),
              ("minimizer_scan", "kaptive_tpu/ops/minimizer.py:146", "flat", ranged["sparse"][1]))),
        {"name": "arch_viterbi_wide", "route": "cuda", "source": "kaptive_tpu_torch/csrc/viterbi.cu",
         "replaces": "kaptive_tpu/bgc/kernels.py:83", "launches": ranged["launches"]["viterbi.cuda.arch_wide"],
         "max_abs_err": arch_w["max_abs_err"], "ms": arch_w["ms"], "plain_ms": arch_w["plain_ms"],
         "bound_ms": arch_w["bound_ms"], "bound_by": arch_w["bound_by"], "library_ms": None,
         "longest_rows": arch_w["longest_rows"]},
    ]
    print(f"# ms / plain_ms: SWG on the extension bucket {ext['shape']}; protein_ms / protein_plain_ms: "
          f"protein bucket {prot['shape']} (B, rows_max, w_pad); wide_form_ms: the fill's wide form on "
          f"{wide['shape']}; launches: host-seeded measured pass (device-seeded pass: fill {dev_swg['fill']}, "
          f"traceback {dev_swg['traceback']}, scan {scan_launches}); scan on the batch {scan_check['shape']} "
          f"(B, rows); CIGAR traceback on the bucket {cigar_check['shape']}, planted_ms: the planted bucket of that "
          f"geometry; gene_viterbi on the clean assembly's launch (its two strands), draft_ms on the draft "
          f"assembly's launch (plain on the CPU); arch_viterbi on the largest main-path launch (plain on "
          f"the CPU); launches: BGC phase; mesh_launches: the two measured mesh passes of step 11 "
          f"{MESH_SHAPES}; mesh_shape / mesh_max_abs_err: the largest extension shard and the largest data "
          f"row's scan recorded in them, held to the plain forms; minimizer_scan (and flat_scan_* on the "
          f"rowcompact_scan entry, the same library) on the (B, L) stream {flat['shape']} of step 12, launches: "
          f"step 12's overflowing screen; swg_fill_cluster on the F7 bucket {f7['shape']} (int32_*: the "
          f"BLOSUM62 x 20 bucket {i32['shape']}), swg_fill_segmented on the bucket {seg['shape']} past the largest "
          f"cluster, rowcompact_scan_any on the (17, 40) batch {rc_any['shape']} and "
          f"minimizer_scan_any on the (17, 40) stream {flat_any['shape']} (w1100_*: one 1 Mb stream at w = 1,100), "
          f"*_scan_sparse (the sparse-table form) on that 1 Mb stream at w = {ranged['w_sparse']}, "
          f"arch_viterbi_wide on the 257-state draft launch (longest_rows: its longest contig), launches: step "
          f"12(f); {N_ASSEMBLIES / elapsed:.3f} asm/s "
          f"host-seeded, {N_ASSEMBLIES / dev_elapsed:.3f} device-seeded; CLI {cli_walls['host']:.3f} / "
          f"{cli_walls['device']:.3f} s wall host / device-seeded, installed CLI {install_walls['host']:.3f} / "
          f"{install_walls['device']:.3f} s; screen {screen_rate:.3f} asm/s [{card}]",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
