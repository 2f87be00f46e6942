#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, type, check, time.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

It needs one card, no network and no jax.  Steps:

1. Print the card's ``name, power.limit`` (``nvidia-smi``), refuse to run
   without CUDA, and build the Hopper kernels (``kaptive_tpu_torch/csrc/swg.cu``,
   nvcc into ``build/``) and the native host library, printing build seconds.
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

``python3 chip_smoke.py --measure`` then also measures, before the last lines:

6. bench.py's full 32 assemblies, typed in stream batches of 32 and of 8,
   three timed passes each after a priming pass (every pass and the median
   printed), and one more batch-32 pass under ``torch.profiler`` for the
   card's busy share and its time per kernel.
7. Synthetic full-size DP buckets (seeded pairs, query lengths within 200 of
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


def build_workload(n_assemblies: int, seed: int = SEED):
    """bench.py's database (140 loci x 18 genes) and ``n_assemblies`` 5.3 Mb assemblies
    cycling through its composition classes: ``(db, [(name, truth, class, fasta)])``."""
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
    names = list(truth["loci"])
    flank = int(GENOME_MB * 1e6 / 2)
    assemblies = []
    for i in range(n_assemblies):
        locus = names[rng.integers(0, len(names))]
        kind = KINDS[i % len(KINDS)]
        assemblies.append((f"asm{i}", locus, kind, _compose_fasta(rng, kind, truth["loci"][locus]["seq"], flank)))
    return db, assemblies


def type_all(serotyper, assemblies, batch_size: int):
    """One ``stream_type`` pass over in-memory FASTA streams; raises on any wrong locus call.
    Returns ``(results, host wall seconds)``."""
    from kaptive_tpu_torch.parallel import stream_type

    streams = [io.BytesIO(fasta) for *_, fasta in assemblies]
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
    full-size synthetic buckets (see the module docstring, steps 6 and 7)."""
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

    db, assemblies = build_workload(MEASURE_ASSEMBLIES)
    serotyper = Serotyper(db, device="cuda")
    type_all(serotyper, assemblies, MEASURE_ASSEMBLIES)  # priming pass
    for batch in (MEASURE_ASSEMBLIES, 8):
        rates = []
        for _ in range(MEASURE_PASSES):
            reset_phases()
            _, seconds = type_all(serotyper, assemblies, batch)
            rates.append(MEASURE_ASSEMBLIES / seconds)
        print(f"# measure: {MEASURE_ASSEMBLIES} assemblies in stream batches of {batch}, "
              f"{MEASURE_ASSEMBLIES}/{MEASURE_ASSEMBLIES} correct in each pass: "
              f"{', '.join(f'{r:.3f}' for r in rates)} asm/s, median {statistics.median(rates):.3f} "
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
    print(f"# measure: profiled batch-{MEASURE_ASSEMBLIES} pass {seconds:.4f} s, card busy "
          f"{busy_ms:.3f} ms = busy share {busy_ms / 1e3 / seconds:.5f} [{card}]; by device time:",
          flush=True)
    for name, times in sorted(per_kernel.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"#   {sum(times):9.3f} ms  {len(times):4d} x  {name[:100]}", flush=True)

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
    from kaptive_tpu_torch.ops import swg_cuda
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.utils.device import card_info, require_cuda

    os.environ["KAPTIVE_PROFILE"] = "1"
    require_cuda()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    print(f"# card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    swg_cuda.build()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in swg_cuda.BUILD_LOG.read_text().splitlines() if "registers" in ln]
    print(f"# nvcc build of csrc/swg.cu: {build_s:.1f} s; ptxas: {' | '.join(regs)}", flush=True)
    t0 = time.perf_counter()
    from kaptive_tpu.native import hostio  # noqa: F401  (g++ build of native/hostio.cpp)

    print(f"# native hostio build/load: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    db, assemblies = build_workload(N_ASSEMBLIES)
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
        [io.BytesIO(assemblies[i][3]) for i in sample]
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
    ]
    print(f"# ms / plain_ms: extension bucket {ext['shape']}; protein_ms / protein_plain_ms: "
          f"protein bucket {prot['shape']} (B, rows_max, w_pad); {N_ASSEMBLIES / elapsed:.3f} "
          f"assemblies/s [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
