r"""CLI commands for serotyping: ``type`` and ``convert`` plus the output writer pipeline.

Capability parity with upstream Kaptive's ``kaptive/serotyping/cli.py``:
``ResultExporter`` (:20-114) binding TSV / PHA4GE / JSONL / per-assembly FASTA
(fna/ffn/faa) / HTML plot writers once, ``Type`` (:118-210) with the
confidence and other-options flags, and ``Convert`` (:214-267) re-exporting
serialised JSONL without recompute.  JSON writing uses the stdlib encoder with
numpy coercion (the reference uses orjson's OPT_SERIALIZE_NUMPY; byte content
of each line is equivalent JSON).

``type`` has the JAX package's flags and defaults, and ``--device {cuda,cpu}``
(default ``cuda``) takes the place of its ``JAX_PLATFORMS`` backend choice.
It runs the port's :class:`~kaptive_tpu_torch.serotyping.core.Serotyper`,
:func:`~kaptive_tpu_torch.parallel.pipeline.stream_type` and
:func:`~kaptive_tpu_torch.utils.profiling.device_trace`; ``--profile`` also
prints the pipeline's counters (which kernels launched, how often).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Any

import numpy as np

from kaptive_tpu_torch.cli import Cli, Colors, Command, add_output_arguments


def _json_default(o: Any):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer, np.floating, np.bool_)):
        return o.item()
    if isinstance(o, bytes):
        return o.decode("utf-8")
    if hasattr(o, "value"):  # IntFlag / IntEnum
        return int(o)
    raise TypeError(f"Cannot serialise {type(o)}")


def result_to_jsonl_bytes(result: Any) -> bytes:
    r"""One JSONL line for a result (compact separators, trailing newline)."""
    return json.dumps(result.to_dict(), default=_json_default, separators=(",", ":")).encode() + b"\n"


def _open_append_aware(cli: Cli, file: str, header: bytes | None):
    r"""Open a tabular/JSONL output with the reference's append semantics
    (ref ``docs/serotyping/outputs.md:20-27``): an existing non-empty file is
    appended to with the header suppressed, so successive runs can stream
    into one table; everything else (new file, stdout) writes fresh."""
    from pathlib import Path

    path = Path(str(file))
    if str(file) not in ("stdout", "-") and path.is_file() and path.stat().st_size > 0:
        return cli.open_file(str(file), mode="ab")
    handle = cli.open_file(str(file), mode="wb")
    if header:
        handle.write(header)
    return handle


class ResultExporter:
    r"""Evaluates output flags once and builds the writer pipeline."""

    file_suffix = "kaptive_results"

    def __init__(self, cli: Cli, args: argparse.Namespace) -> None:
        self.writers = []

        if tsv_file := getattr(args, "out", getattr(args, "tsv", None)):
            from kaptive_tpu_torch.serotyping import KaptiveRow

            tsv_handle = _open_append_aware(cli, tsv_file, KaptiveRow.header())
            self.writers.append(lambda r: tsv_handle.write(bytes(KaptiveRow.from_result(r))))

        if pha4ge_file := getattr(args, "pha4ge", None):
            from kaptive_tpu_torch.serotyping import Pha4geRow

            pha4ge_handle = _open_append_aware(cli, str(pha4ge_file), Pha4geRow.header())
            self.writers.append(lambda r: pha4ge_handle.write(bytes(Pha4geRow.from_result(r))))

        if json_file := getattr(args, "json", None):
            json_handle = _open_append_aware(cli, json_file, None)
            self.writers.append(lambda r: json_handle.write(result_to_jsonl_bytes(r)))

        # Directory sinks are created up front (first-run ergonomics; the
        # reference requires them to pre-exist).
        for sink_attr in ("loci", "genes", "proteins", "plots"):
            if sink_dir := getattr(args, sink_attr, None):
                Path(sink_dir).mkdir(parents=True, exist_ok=True)

        if loci_dir := getattr(args, "loci", None):
            self.writers.append(
                lambda r: (loci_dir / f"{r.genome}_{self.file_suffix}.fna").write_bytes(
                    r.locus_seqs.to_fasta()
                )
            )

        if genes_dir := getattr(args, "genes", None):
            self.writers.append(
                lambda r: (genes_dir / f"{r.genome}_{self.file_suffix}.ffn").write_bytes(
                    r.gene_seqs.to_fasta()
                )
            )

        if proteins_dir := getattr(args, "proteins", None):
            self.writers.append(
                lambda r: (proteins_dir / f"{r.genome}_{self.file_suffix}.faa").write_bytes(
                    r.translations.to_fasta()
                )
            )

        if plot_dir := getattr(args, "plots", None):
            from kaptive_tpu_torch.plotting import SerotypingResultPlotter

            plotter = SerotypingResultPlotter()
            self.writers.append(
                lambda r: plotter(r).write_html(plot_dir / f"{r.genome}_{self.file_suffix}.html")
            )

    def __call__(self, result: Any) -> None:
        for write in self.writers:
            write(result)


class Type(Command):
    r"""💉 In silico serotyping of genome assemblies.

    Aliases:
        assembly
    """

    aliases = ["assembly"]

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        opts = parser.add_argument_group(Colors.wrap("📥 Inputs", Colors.BOLD))
        opts.add_argument("database", help="Database path or keyword (see: `kaptive-tpu-torch db list`)")
        opts.add_argument(
            "genomes", nargs="+", help="Genome assemblies in fasta format; can be compressed"
        )

        opts = parser.add_argument_group(Colors.wrap("📤 Outputs", Colors.BOLD))
        add_output_arguments(opts, tsv_flags=("-o", "--out"), include_json=True)

        opts = parser.add_argument_group(Colors.wrap("🔬 Confidence options", Colors.BOLD))
        opts.add_argument(
            "--max-other-genes", type=int, metavar="", default=1,
            help="Typeable if <= other genes (default: %(default)s)",
        )
        opts.add_argument(
            "--min-completeness", type=float, metavar="", default=0.5,
            help="Typeable if >= completeness (default: %(default)s)",
        )
        opts.add_argument(
            "--below-threshold", action="store_true",
            help="Typeable if any genes in locus are below threshold (default: False)",
        )

        opts = parser.add_argument_group(Colors.wrap("🔧 Other options", Colors.BOLD))
        opts.add_argument(
            "-t", "--threads", type=int, default=0, metavar="",
            help="Host ingest threads (FASTA parse/encode/pack) or 0 for all available "
            "(default: 0)",
        )
        opts.add_argument(
            "--partial-edge-tolerance", type=int, default=5, metavar="",
            help="Tolerance in bases from contig edge to call a partial gene (default: %(default)s)",
        )
        opts.add_argument(
            "--batch-size", type=int, default=0, metavar="",
            help="Assemblies typed per device batch; 0 = auto (default: %(default)s)",
        )
        opts.add_argument(
            "--profile", action="store_true",
            help="Print per-phase wall-time totals and the pipeline's counters (kernel "
            "launches, fallbacks) to stderr after the run (set KAPTIVE_TRACE_DIR to also "
            "write a torch.profiler Chrome trace there, the phases' spans on its timeline)",
        )
        opts.add_argument(
            "--screen-only", action="store_true",
            help="Fast approximate mode: report only the best-matching locus and its "
            "weighted screen score per assembly (the scoring phase alone; no "
            "reconstruction, gene table, phenotype or confidence). TSV columns: "
            "Assembly, Best match locus, Score (default: False)",
        )
        opts.add_argument(
            "--precompile", action="store_true",
            help="Build the CUDA kernels and type one synthetic batch "
            "(Serotyper.warmup) before streaming genomes, so the first real batch pays "
            "no build or first-launch cost (default: False)",
        )
        opts.add_argument(
            "--seed-mode", choices=("auto", "host", "device"), default=None, metavar="",
            help="Where the mapper's seed/chain stages run: 'host' = native C scan "
            "on the ingest pool, 'device' = minimizer scan kernel, table match and chaining "
            "on the card, 'auto' = device on a CUDA device, host on the CPU "
            "(default: auto; both modes produce identical results)",
        )
        opts.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda", metavar="",
            help="Device the kernels run on: 'cuda' = the Hopper kernels on the first "
            "card (fails without one), 'cpu' = their plain PyTorch versions "
            "(slow; default: %(default)s)",
        )

    def run(self, args: argparse.Namespace) -> None:
        from kaptive_tpu_torch.utils.device import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as err:
            self.cli.fail(str(err))
        self.cli.msg(f"💽 Loading database {args.database}...")
        from kaptive_tpu_torch.db import DatabaseManager
        from kaptive_tpu_torch.utils.metrics import metrics_report

        from kaptive_tpu_torch.parallel.pipeline import auto_batch_size, stream_type
        from kaptive_tpu_torch.serotyping import Serotyper
        from kaptive_tpu_torch.utils.profiling import device_trace, phase_report

        db = DatabaseManager.get(args.database)

        if args.screen_only:
            self._screen_only(args, db)
            return
        exporter = ResultExporter(self.cli, args)

        serotyper = Serotyper(
            db=db,
            max_other_genes=args.max_other_genes,
            min_completeness=args.min_completeness,
            allow_below_threshold=args.below_threshold,
            partial_edge_tolerance=args.partial_edge_tolerance,
            device=args.device,
        )
        if args.profile:
            os.environ["KAPTIVE_PROFILE"] = "1"
        if args.seed_mode:
            os.environ["KAPTIVE_SEED_MODE"] = args.seed_mode

        batch_size = args.batch_size or auto_batch_size()
        if args.precompile:
            self.cli.msg("🔥 Building kernels and warming up...")
            elapsed = serotyper.warmup(batch_size=batch_size)
            self.cli.msg(f"🔥 Warm-up done in {elapsed:.1f}s")
        with device_trace():
            results = stream_type(
                serotyper, args.genomes, batch_size=batch_size,
                max_workers=args.threads or None,
            )
            for result in self.cli.progress(results, "💉 Serotyping genomes..."):
                if result:
                    exporter(result)

        if args.profile:
            phase_report()
            metrics_report()
        self.cli.msg(f"✅ Serotyping complete. Results written to '{args.out}'.")

    def _screen_only(self, args: argparse.Namespace, db) -> None:
        r"""Approximate triage mode: one screen pass per batch, 3-column TSV."""
        # The screen produces no gene table / sequences / full result, so any
        # other output flag would be silently unhonoured — reject loudly.
        conflicting = [
            flag for flag, attr in (
                ("--json", "json"), ("--pha4ge", "pha4ge"), ("--loci", "loci"),
                ("--genes", "genes"), ("--proteins", "proteins"), ("--plots", "plots"),
            )
            if getattr(args, attr, None)
        ]
        if conflicting:
            self.parser.error(
                f"--screen-only writes only the 3-column triage TSV; remove "
                f"{', '.join(conflicting)} or run a full typing pass"
            )
        from kaptive_tpu_torch.parallel.pipeline import auto_batch_size
        from kaptive_tpu_torch.serotyping import Serotyper

        serotyper = Serotyper(db=db, device=args.device)
        batch_size = args.batch_size or auto_batch_size()
        handle = _open_append_aware(
            self.cli, args.out or "stdout", b"Assembly\tBest match locus\tScore\n"
        )
        genome_list = list(args.genomes)
        batches = range(0, len(genome_list), batch_size)
        for start in self.cli.progress(batches, "🔍 Screening batches..."):
            assemblies, best, weighted = serotyper.screen(
                genome_list[start : start + batch_size]
            )
            for i, ga in enumerate(assemblies):
                b = int(best[i])
                handle.write(
                    b"%s\t%s\t%.2f\n"
                    % (ga.id.encode(), db.loci.ids[b].encode(), weighted[i, b])
                )
        self.cli.msg("✅ Screening complete.")


class Convert(Command):
    r"""🔄 Convert serialized Kaptive results into different formats.

    Reads serialized JSON-lines serotyping output records and converts them into tabular
    TSV, PHA4GE TSV, or sequence FASTA files without re-running the serotyping pipeline.
    """

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        opts = parser.add_argument_group(Colors.wrap("📥 Inputs", Colors.BOLD))
        opts.add_argument(
            "jsonl", nargs="?", default="stdin",
            help="Serialised results in JSON-lines format (default: stdin; '-' also accepted)",
        )
        opts = parser.add_argument_group(Colors.wrap("📤 Outputs", Colors.BOLD))
        add_output_arguments(opts, tsv_flags=("-t", "--tsv"), include_json=False)

    def run(self, args: argparse.Namespace) -> None:
        from kaptive_tpu_torch.serotyping import SerotypingResult

        exporter = ResultExporter(self.cli, args)
        handle = self.cli.open_file(args.jsonl, mode="rb")
        for line in self.cli.progress(handle, "💱 Converting results..."):
            line = line.strip()
            if not line:
                continue
            result = SerotypingResult.from_dict(json.loads(line))
            exporter(result)
        self.cli.msg("✅ Conversion complete.")
