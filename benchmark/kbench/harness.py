r"""One run of one benchmark cell, driven by the files that name it.

``BENCHMARK.json`` names the cell's configuration (its ``file``) and
traffic mix (``benchmark/traffic/<traffic>.json``).  The mix names the
entry that drives the program, ``benchmark/entries/<entry>.py``, a module
with ``warm(drive)`` (set-up: every shape the window uses, once) and
``window(drive)`` (the measured window), and the environment the program
runs under (``env``, such as its seeding mode).  Each end-to-end metric is
read by ``benchmark/end_to_end/<name>.py`` and each per-layer metric by
``benchmark/layer_metrics/<name>.py``, a module with ``read(run)`` that
returns a number or ``None`` when it finds nothing to read.  A cell, a
configuration, a mix, an entry or a metric is added by adding files.

A run: make the database and the traffic pool from the seed, load the
database and warm the program up at the cell's own entry and batch size
(all of it ``setup_s``), drive the entry for ``seconds``,
check that no JAX module was loaded, read the device's peak memory, free
the program, and judge a sample of what the window produced against the
plain reference.  With ``trace`` a stretch of half the window, from a
quarter of the way in, runs under ``torch.profiler`` and the program's
phase timers, and the per-layer metrics are reported instead of the
end-to-end ones.
"""

from __future__ import annotations

import importlib.util
import io
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path


from kbench import gen
from kbench.modcheck import forbidden_loaded
from kbench.trace import DeviceSummary, read_chrome_trace, summarize

CHECKS = ("failed", "wrong_calls", "unstable_rows", "missing_genes", "ext_short", "pident_off", "row_faults")


class HarnessError(RuntimeError):
    r"""A run that cannot give a result (no card, a foreign module, traffic run out)."""


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _listed(metric: dict, cell: str, reported: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(root: Path, name: str) -> Cell:
    r"""The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if _listed(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _listed(m, name, reported)]
    return Cell(
        name,
        json.loads((root / config["file"]).read_text()),
        json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text()),
        e2e,
        layer,
    )


def load_module(root: Path, kind: str, name: str):
    r"""The module ``root/benchmark/<kind>/<name>.py``, found by its name."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None or not path.is_file():
        raise HarnessError(f"no module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, kind: str, name: str):
    return load_module(root, kind, name).read


@dataclass
class Run:
    r"""What the readers read: the window's stamps and, traced, the stretch's phases and device summary."""

    seconds: float
    setup_s: float
    done_at: list[float] = field(default_factory=list)
    turnaround_s: list[float] = field(default_factory=list)
    window_start: float = 0.0
    stretch_rows: int = 0
    phases: dict[str, float] = field(default_factory=dict)  # name -> seconds over the stretch
    device: DeviceSummary | None = None
    spans: list[tuple[float, float, str]] = field(default_factory=list)  # harness spans, host clock


class _Observer:
    r"""Every row of the window: the call (locus and phenotype), the row's stability, a kept sample."""

    def __init__(self, pool, sample: set[int], phenotypes: list[str]) -> None:
        self.pool = pool
        self.sample = sample
        self.phenotypes = phenotypes  # each pool entry's, worked out by the reference from what was planted
        self.kept: dict[int, tuple] = {}
        self.rows: dict[int, bytes] = {}
        self.counts = dict.fromkeys(CHECKS, 0)
        self.attempted = 0
        self.notes: list[str] = []

    def see(self, idx: int, result, row: bytes | None) -> None:
        self.attempted += 1
        asm = self.pool[idx]
        if result is None or row is None:
            self.counts["failed"] += 1
            return
        if result.best_locus_name != asm.locus.name or result.phenotype != self.phenotypes[idx]:
            self.counts["wrong_calls"] += 1
            if len(self.notes) < 10:
                self.notes.append(f"{asm.name}: called {result.best_locus_name} {result.phenotype!r}, "
                                  f"planted {asm.locus.name} {self.phenotypes[idx]!r}")
        first = self.rows.setdefault(idx, row)
        if first != row:
            self.counts["unstable_rows"] += 1
        if idx in self.sample and idx not in self.kept:
            self.kept[idx] = (asm, result, row)


class _Stretch:
    r"""The traced middle half of the window: profiler, phase timers, annotations."""

    def __init__(self, run: Run, trace: bool, device) -> None:
        self.run, self.enabled, self.device = run, trace, device
        self.state = "before"
        self.prof = self.mark = None
        self.rows_at_start = 0
        self.t0 = 0.0

    def warm(self) -> None:
        r"""Start and stop the profiler once in set-up: its first start loads the tracing
        library, which takes seconds, and would otherwise eat the stretch."""
        if self.enabled:
            self._profile().__enter__().__exit__(None, None, None)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        return profile(activities=acts)

    def tick(self, now: float, rows: int) -> None:
        r"""Start the stretch at a quarter of the window; end it half a window after it started."""
        if not self.enabled:
            return
        if self.state == "before" and now >= self.run.window_start + 0.25 * self.run.seconds:
            from torch.profiler import record_function

            from kaptive_tpu_torch.utils.profiling import reset_phases

            self.prof = self._profile()
            self.prof.start()
            reset_phases()
            self.mark = record_function("bench.stretch")
            self.t0 = time.perf_counter()
            self.mark.__enter__()
            self.rows_at_start, self.state = rows, "on"
        elif self.state == "on" and now >= self.t0 + 0.5 * self.run.seconds:
            self.finish(rows)

    def finish(self, rows: int) -> None:
        if self.state != "on":
            return
        from kaptive_tpu_torch.utils.profiling import phase_report

        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"
        self.run.stretch_rows = rows - self.rows_at_start
        with open(os.devnull, "w") as sink:
            self.run.phases = {k: total for k, (_, total) in phase_report(sink).items()}
        host = [(a - self.t0, b - self.t0, name) for a, b, name in list(self.run.spans) if b >= self.t0]
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            self.run.device = summarize(read_chrome_trace(path), host)
        self.prof = None


def handle(asm: gen.Assembly) -> io.BytesIO:
    r"""The FASTA bytes of ``asm`` as the file handle the program's entries take."""
    h = io.BytesIO(asm.fasta)
    h.name = asm.name
    return h


def row_bytes(result) -> bytes | None:
    r"""The report row of ``result`` as the program writes it (``None`` for no result)."""
    from kaptive_tpu_torch.serotyping.io import KaptiveRow

    return bytes(KaptiveRow.from_result(result)) if result is not None else None


@dataclass
class Drive:
    r"""What an entry (``benchmark/entries/<name>.py``) drives and fills: the program, the
    traffic's pool and parameters, the run's stamps, the observer of every row, the traced
    stretch, and the clock."""

    serotyper: object
    pool: list
    traffic: dict
    run: Run
    observer: _Observer
    stretch: _Stretch
    clock: object
    device: object
    state: dict = field(default_factory=dict)  # the entry's own, from its warm-up to its window


class _Stages:
    r"""The serotyper's two stage calls, timed on the host clock whatever thread makes
    them: their calls, wall seconds and the calling thread's CPU seconds, and, traced,
    spans for the breakdown (the profiler records annotations made on the stream's map
    thread unreliably)."""

    NAMES = ("map_batch", "finish_batch")

    def __init__(self, serotyper, spans: list | None) -> None:
        self.totals = {name: [0, 0.0, 0.0] for name in self.NAMES}
        for name in self.NAMES:
            inner = getattr(serotyper, name)

            def wrapped(*args, _inner=inner, _name=name, **kw):
                t, c = time.perf_counter(), time.thread_time()
                try:
                    return _inner(*args, **kw)
                finally:
                    t1 = time.perf_counter()
                    tot = self.totals[_name]
                    tot[0] += 1
                    tot[1] += t1 - t
                    tot[2] += time.thread_time() - c
                    if spans is not None:
                        spans.append((t, t1, _name))

            setattr(serotyper, name, wrapped)

    def reset(self) -> None:
        for tot in self.totals.values():
            tot[:] = [0, 0.0, 0.0]


def _steal_s() -> float:
    r"""Seconds the hypervisor ran others on this machine's CPUs, summed over them (0 where unknown)."""
    try:
        with open("/proc/stat", encoding="ascii") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def _sample(pool, traffic, rng, phenotypes: list[str]) -> set[int]:
    r"""The pool entries the reference checks: the longest locus, the most
    contigs, then others drawn from the seed up to ``check_sample``.  Where
    the mix plants extra genes or knockouts, the first entry of each
    phenotype in the drawn order comes before the others."""
    n = min(traffic["check_sample"], len(pool))
    picked = [
        max(range(len(pool)), key=lambda i: len(pool[i].locus.seq)),
        max(range(len(pool)), key=lambda i: len(pool[i].contig_starts)),
    ]
    order = rng.permutation(len(pool))
    if any("extra_sets" in c or "knockout" in c for c in traffic["classes"]):
        seen = {phenotypes[i] for i in picked}
        for i in order:
            if phenotypes[i] not in seen and len(set(picked)) < n:
                seen.add(phenotypes[i])
                picked.append(int(i))
    for i in order:
        if len(set(picked)) >= n:
            break
        picked.append(int(i))
    return set(picked[: max(n, 2)])


@dataclass
class Outcome:
    line: dict
    checks: dict[str, tuple[int, int]]
    notes: list[str]
    checked: list = field(default_factory=list)  # (assembly, result, row, header) the reference judged
    genes: dict = field(default_factory=dict)  # every gene of the database by its id
    id_threshold: float = 0.0


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device_name: str,
             t_process: float) -> Outcome:
    r"""One run of ``workload``; ``t_process`` is the process's start on ``time.perf_counter``."""
    import torch

    clock = time.perf_counter
    cell = load_cell(root, workload)
    cfg, traffic = cell.config, cell.traffic
    entry = load_module(root, "entries", traffic["entry"])
    for key, value in traffic.get("env", {}).items():  # the program's settings, such as its seeding mode
        os.environ[key] = str(value)
    if trace:
        os.environ["KAPTIVE_PROFILE"] = "1"
    else:
        os.environ.pop("KAPTIVE_PROFILE", None)

    from kaptive_tpu_torch.db import Database
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.serotyping.io import KaptiveRow

    device = torch.device(device_name)
    rng_db, rng_pool, rng_sample = gen.seed_streams(seed, 3)
    synthetic = gen.make_database(cfg, rng_db)
    with tempfile.TemporaryDirectory() as tmp:
        gbk = Path(tmp) / f"{cfg['db_name']}.gbk"
        gbk.write_text(synthetic.genbank)
        gbk.with_suffix(".toml").write_text(synthetic.toml)
        db = Database.from_genbank(gbk)
    pool = gen.make_pool(traffic, synthetic, cfg["genome_nt"], rng_pool)
    from reference.phenotype import expected_phenotypes

    phenotypes = expected_phenotypes(pool, synthetic, cfg)
    sample = _sample(pool, traffic, rng_sample, phenotypes)

    serotyper = Serotyper(db, device=device)
    serotyper.warmup(genome_length=cfg["genome_nt"], batch_size=traffic.get("batch_size", 1))
    run = Run(seconds=seconds, setup_s=0.0)
    observer = _Observer(pool, sample, phenotypes)
    stretch = _Stretch(run, trace, device)
    stages = _Stages(serotyper, run.spans if trace else None)
    stretch.warm()
    drive = Drive(serotyper, pool, traffic, run, observer, stretch, clock, device)
    entry.warm(drive)
    if device.type == "cuda":
        torch.cuda.synchronize()
    run.setup_s = clock() - t_process
    stages.reset()
    cpu0, steal0 = time.process_time(), _steal_s()
    entry.window(drive)
    host = {"process CPU": time.process_time() - cpu0, "steal": _steal_s() - steal0}

    found = forbidden_loaded()
    if found:
        raise HarnessError(f"forbidden modules were loaded: {', '.join(found)}")
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    del serotyper
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from reference.judge import judge

    header = KaptiveRow.header()
    checked = [(asm, result, row, header) for asm, result, row in (observer.kept[i] for i in sorted(observer.kept))]
    genes = gen.gene_table(synthetic)
    t_judge = clock()
    verdict = judge(checked, genes, float(cfg["id_threshold"]), device, rng_sample,
                    phenotypes={asm.name: phenotypes[i] for i, asm in enumerate(pool)})
    t_judge = clock() - t_judge
    counts = dict(observer.counts)
    counts.update(verdict.counts)
    checks = {name: (counts[name], 0) for name in CHECKS}
    bins = [0] * max(1, math.ceil(seconds / 5))
    for t in run.done_at:
        bins[min(len(bins) - 1, int((t - run.window_start) / 5))] += 1
    notes = observer.notes + verdict.notes + [
        f"checked {len(checked)} assemblies of {len(sample)} sampled: {verdict.genes} planted genes, "
        f"{verdict.hits} hits of them, {verdict.other_hits} hits of other loci's genes; "
        f"{verdict.undecided} protein identities that no gapless optimum decides; the reference took {t_judge:.3f} s",
        f"rows a 5 s of the window: {bins}",
        "host over the window: " + ", ".join(f"{k} {v:.3f} s" for k, v in host.items()) + "; " + "; ".join(
            f"{name} {n} calls, {wall:.3f} s wall, {cpu:.3f} s its thread's CPU"
            for name, (n, wall, cpu) in stages.totals.items()
        ),
    ]

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(root, "layer_metrics", m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {
            m["name"]: {"value": load_reader(root, "end_to_end", m["name"])(run), "unit": m["unit"]}
            for m in cell.end_to_end
        }
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    line = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": observer.attempted,
        "failed": observer.counts["failed"],
        "metrics": metrics,
        "device": dev,
    }
    if trace and run.device is not None:
        dev["busy_s"] = run.device.busy_s
        dev["window_s"] = run.device.window_s
        line["breakdown"] = {"device_ops": run.device.device_ops, "idle_gaps": run.device.idle_gaps}
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return Outcome(line, checks, notes, checked, genes, float(cfg["id_threshold"]))


def print_outcome(out: Outcome, stream=sys.stdout, err=sys.stderr) -> None:
    for note in out.notes:
        print(f"# {note}", file=err)
    for name, (value, limit) in out.checks.items():
        print(f"check {name} {value} limit {limit}", file=err)
    err.flush()
    print(json.dumps(out.line), file=stream, flush=True)
