r"""The ``type`` command on the port (counterpart of :class:`kaptive_tpu.serotyping.cli.Type`).

Flags, defaults and the ``assembly`` alias are inherited from the JAX
package's ``Type.arguments``; three help strings that spoke of jax, XLA and
Pallas are reworded for the port, and ``--device {cuda,cpu}`` (default
``cuda``) takes the place of the JAX package's ``JAX_PLATFORMS`` backend
choice.  ``run`` and ``_screen_only`` mirror the JAX package's with the
port's :class:`~kaptive_tpu_torch.serotyping.core.Serotyper`,
:func:`~kaptive_tpu_torch.parallel.pipeline.stream_type` and
:func:`~kaptive_tpu_torch.utils.profiling.device_trace`; ``--profile`` also
prints the pipeline's counters (which kernels launched, how often).  The output writers
(``ResultExporter``, ``_open_append_aware``) and ``convert`` are the JAX
package's, reused unchanged.
"""

from __future__ import annotations

import argparse
import os

from kaptive_tpu.serotyping.cli import ResultExporter, _open_append_aware
from kaptive_tpu.serotyping.cli import Type as _JaxType

_PORT_HELP = {
    "profile": "Print per-phase wall-time totals and the pipeline's counters (kernel "
    "launches, fallbacks) to stderr after the run (set KAPTIVE_TRACE_DIR to also "
    "write a torch.profiler Chrome trace there)",
    "precompile": "Build the CUDA kernels and type one synthetic batch "
    "(Serotyper.warmup) before streaming genomes, so the first real batch pays "
    "no build or first-launch cost (default: False)",
    "seed_mode": "Where the mapper's seed/chain stages run: 'host' = native C scan "
    "on the ingest pool, 'device' = minimizer scan kernel, table match and chaining "
    "on the card, 'auto' = host where the native library builds "
    "(default: auto; both modes produce identical results)",
}


class Type(_JaxType):
    __doc__ = _JaxType.__doc__  # the command's help text, as the JAX package's

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        super().arguments(parser)
        for action in parser._actions:
            if action.dest in _PORT_HELP:
                action.help = _PORT_HELP[action.dest]
        other = next(g for g in parser._action_groups if "Other options" in str(g.title))
        other.add_argument(
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
        from kaptive_tpu.db import DatabaseManager
        from kaptive_tpu.utils.metrics import metrics_report

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
