r"""Command line of the port: the command framework and ``kaptive-tpu-torch {db,type,convert}``.

Run as the ``kaptive-tpu-torch`` console script or ``python -m kaptive_tpu_torch.cli``::

    python -m kaptive_tpu_torch.cli type db.gbk a.fasta b.fasta -o out.tsv            # on the card
    python -m kaptive_tpu_torch.cli type db.gbk a.fasta --device cpu -o out.tsv       # plain PyTorch

Capability parity with upstream Kaptive's ``kaptive/cli.py``: colorized help
with ``NO_COLOR`` support, help-on-error parsing with did-you-mean hints, a
``Cli`` host (handle tracking, exit-code mapping, verbose/progress output on
stderr), a declarative command tree, and ``main()``.  The framework idiom is
this repo's own: a command's subtree is a class-attribute ``children`` roster
(instantiated, not registered imperatively), flags are declared by
``arguments(parser)`` / ``lineage_arguments(parser)`` hooks that receive the
parser they populate, and the action hook is ``run(ns)`` — a class that leaves
it untouched is a pure command group.  Styling is a module function, exit-code
mapping and the shared output flag block are data tables.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from collections.abc import Iterable, Iterator
from difflib import get_close_matches
from pathlib import Path
from typing import IO, Any

from kaptive_tpu_torch._version import __version__

# SGR escapes (wire constants)
RESET, BOLD, BOLD_RED, BOLD_CYAN = ("\033[%sm" % c for c in ("0", "1", "1;31", "1;36"))

_WANT_COLOR = sys.stdout.isatty() and not os.environ.get("NO_COLOR")


def paint(text: str, *styles: str) -> str:
    r"""Apply SGR styles unless color output is disabled."""
    return f"{''.join(styles)}{text}{RESET}" if _WANT_COLOR else text


class Colors:
    r"""Compatibility namespace over the module-level styling helpers."""

    ENABLED = _WANT_COLOR
    RESET, BOLD, BOLD_RED, BOLD_CYAN = RESET, BOLD, BOLD_RED, BOLD_CYAN
    wrap = staticmethod(paint)


class CliHelpFormatter(argparse.RawTextHelpFormatter):
    r"""Colorized headings, compact ``[subcommand]`` usage, no subparser header."""

    def _format_usage(self, usage, actions, groups, prefix):
        shown_prefix = "usage: " if prefix is None else prefix
        flagless = [a for a in actions if not a.option_strings]
        text = super()._format_usage(usage, flagless, groups, prefix)
        text = re.sub(r"\{[\w,.-]+\}", paint("[subcommand]", BOLD_CYAN), text)
        head = f"{shown_prefix}{self._prog}"
        if text.startswith(head):
            if len(flagless) != len(actions):
                text = f"{head} {paint('[options]', BOLD_CYAN)}{text[len(head):]}"
            text = paint(shown_prefix, BOLD_CYAN) + text[len(shown_prefix):]
        return text

    def start_section(self, heading):
        super().start_section(paint(heading, BOLD_CYAN) if heading else heading)

    def _format_action(self, action):
        text = super()._format_action(action)
        if isinstance(action, argparse._SubParsersAction):
            _, sep, rest = text.partition("\n")
            if sep:
                return rest
        return text


def _suggest_from_error(message: str) -> str | None:
    r"""Fuzzy-match an ``invalid choice`` argparse error against its offered
    alternatives; returns the closest candidate if one is plausible."""
    parsed = re.search(r"invalid choice: '?([^']+)'?.*\(choose from (.*)\)", message)
    if parsed is None:
        return None
    offered = [alt.strip(" '\"") for alt in parsed.group(2).split(",")]
    best = get_close_matches(parsed.group(1), offered, n=1)
    return best[0] if best else None


class HelpOnErrorParser(argparse.ArgumentParser):
    r"""Shows full help plus a did-you-mean hint when parsing fails."""

    def error(self, message: str) -> None:  # type: ignore[override]
        self.print_help(sys.stderr)
        tail = f"\n{paint('Error:', BOLD_RED)} {message}\n"
        if hint := _suggest_from_error(message):
            tail += f"  hint: did you mean {paint(hint, BOLD_CYAN)}?\n"
        self.exit(2, tail)


def _retitle_general_options(parser: argparse.ArgumentParser, to_back: bool) -> None:
    r"""Rename argparse's default optionals group; optionally print it last so
    command-specific groups lead the help output."""
    group = getattr(parser, "_optionals", None)
    if group is not None:
        group.title = paint("General options", BOLD)
        if to_back and group in parser._action_groups:
            parser._action_groups.remove(group)
            parser._action_groups.append(group)


# (exception type, stderr message template, exit code) — BrokenPipe is special.
_EXIT_TABLE: tuple[tuple[type[BaseException], str, int], ...] = (
    (KeyboardInterrupt, "\n🛑 Cancelled by user.", 1),
    (PermissionError, "🔒 Permission denied: {exc}", 1),
    (FileNotFoundError, "📄 File not found: {exc}", 1),
)

_STD_STREAMS = {"stdin": lambda: sys.stdin, "stdout": lambda: sys.stdout}


class Cli:
    r"""Root CLI host: global flags, subcommand registry, handles, progress."""

    def __init__(self, description: str = "", epilog: str = "") -> None:
        # KAPTIVE_VERBOSE pre-arms verbosity (useful under wrappers); -V wins.
        self.verbose = os.environ.get("KAPTIVE_VERBOSE", "").lower() not in ("", "0", "false")
        self._open_handles: list[IO] = []
        self.global_parser = HelpOnErrorParser(add_help=False)
        self.global_parser.add_argument(
            "-V", "--verbose", action="store_true", help="Enable verbose output/progress"
        )
        root_spec = dict(
            description=paint(description, BOLD) if description else None,
            epilog=paint(epilog, BOLD) if epilog else None,
            parents=[self.global_parser],
            formatter_class=CliHelpFormatter,
        )
        self.parser = HelpOnErrorParser(**root_spec)
        self.parser.add_argument(
            "-v", "--version", action="version", version=f"%(prog)s {__version__}",
            help="Show program's version number and exit")
        _retitle_general_options(self.parser, to_back=False)
        self.subparsers = self.parser.add_subparsers(
            title=paint("Commands", BOLD), dest="command", required=True
        )

    # -- command registry & dispatch --------------------------------------

    def mount(self, command: "Command") -> "Command":
        r"""Attach a top-level command (and its subtree) to this host."""
        command.cli = self
        command.attach(self.subparsers, lineage=(self.global_parser,))
        return command

    def dispatch(self, argv: list[str] | None = None) -> None:
        r"""Parse ``argv`` and invoke the selected command's ``run`` hook."""
        ns = self.parser.parse_args(argv)
        self.verbose |= bool(getattr(ns, "verbose", False))
        invoke = getattr(ns, "invoke", None)
        if invoke is None:
            self.parser.print_help()
            return
        from kaptive_tpu_torch.client import KaptiveWebClientError
        from kaptive_tpu_torch.db import DatabaseError

        try:
            invoke(ns)
        except (DatabaseError, KaptiveWebClientError) as exc:
            self.fail(str(exc))

    def fail(self, why: str, code: int = 1) -> None:
        print(f"❌ {why}", file=sys.stderr)
        sys.exit(code)

    # -- lifecycle / exit-code mapping ------------------------------------

    def __enter__(self) -> "Cli":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close_files()
        if exc_type is BrokenPipeError:
            # Redirect stdout into /dev/null so interpreter teardown doesn't
            # raise again while flushing.
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
            sys.exit(130)
        for known, template, code in _EXIT_TABLE:
            if exc_type is known:
                print(template.format(exc=exc_val), file=sys.stderr)
                sys.exit(code)

    def __del__(self) -> None:
        self.close_files()

    def close_files(self) -> None:
        r"""Close every tracked output handle (standard streams excluded)."""
        keep = (sys.stdin, sys.stdout, sys.stderr)
        while self._open_handles:
            if (handle := self._open_handles.pop()) not in keep:
                handle.close()

    # -- stderr UX ---------------------------------------------------------

    def msg(self, text: str | None, **kwargs: Any) -> None:
        if self.verbose:
            print(text, file=sys.stderr, **kwargs)

    def progress(self, iterable: Iterable, msg: str) -> Iterator:
        r"""Yield items while rendering a ``\r i/total`` counter in verbose mode."""
        total = len(iterable) if hasattr(iterable, "__len__") else "?"  # type: ignore[arg-type]
        done = 0
        for done, item in enumerate(iterable, start=1):
            self.msg(f"\r{msg} {done}/{total}", end="", flush=True)
            yield item
        if done:
            self.msg("")

    def open_file(self, file: str, mode: str = "rb") -> IO:
        r"""Open a path, or pass through the standard streams: ``-`` means
        stdin when reading and stdout when writing; ``stdin``/``stdout`` name
        them explicitly.  Real files are tracked for cleanup."""
        if file == "-":
            file = "stdin" if "r" in mode else "stdout"
        if pick := _STD_STREAMS.get(file):
            stream = pick()
            return stream.buffer if "b" in mode else stream
        self._open_handles.append(handle := open(file, mode))
        return handle


# Shared output flag block: (flags, metavar, const, type, help) rows; the
# ``-j`` row is dropped when a command excludes JSON output.
_OUTPUT_FLAG_ROWS: tuple[tuple[tuple[str, ...], str, Any, Any, str], ...] = (
    (("-l", "--loci"), "DIR", "./", Path,
     "Write locus nucleotide fasta files to a directory (default: %(const)s)"),
    (("-g", "--genes"), "DIR", "./", Path,
     "Write gene nucleotide fasta files to a directory (default: %(const)s)"),
    (("-p", "--proteins"), "DIR", "./", Path,
     "Write translation amino-acid fasta files to a directory (default: %(const)s)"),
    (("-j", "--json"), "FILE", "kaptive_results.jsonl", None,
     "Write serialised results to a newline-delimited JSON (default: %(const)s)"),
    (("--pha4ge",), "FILE", "kaptive_results.pha4ge", Path,
     "Write PHA4GE-compliant serotyping report to a TSV file (default: %(const)s)"),
    (("--plots",), "DIR", "./", Path,
     "Generate interactive locus plots to a directory (default: %(const)s)"),
)


def add_output_arguments(opts: argparse._ArgumentGroup,
                         tsv_flags: tuple[str, str] = ("-o", "--out"),
                         include_json: bool = True) -> None:
    r"""Attach the shared result-writer flag block (ref ``cli.py:424-504``)."""
    optional_tsv = tsv_flags[0] == "-t"
    opts.add_argument(
        *tsv_flags,
        metavar="FILE",
        nargs="?" if optional_tsv else None,
        default=None if optional_tsv else "stdout",
        const="stdout" if optional_tsv else None,
        help="Write serotyping results as a TSV report to a file (default: %(" +
             ("const" if optional_tsv else "default") + ")s)",
    )
    for flags, metavar, const, astype, helptext in _OUTPUT_FLAG_ROWS:
        if flags[0] == "-j" and not include_json:
            continue
        extra = {"type": astype} if astype is not None else {}
        opts.add_argument(
            *flags, metavar=metavar, nargs="?", const=const, help=helptext, **extra
        )


class Command:
    r"""Declarative CLI subcommand.

    ``name``/``description``/``help_text`` default from the class name and
    docstring; ``children`` (a roster of Command classes) declares the
    subtree.  Subclasses override ``arguments(parser)`` to declare their own
    flags, ``lineage_arguments(parser)`` to declare flags every child
    inherits, and ``run(ns)`` to act — left untouched, the command is a pure
    group that only routes to its children.
    """

    name = description = help_text = ""
    aliases: tuple[str, ...] = ()
    children: tuple[type["Command"], ...] = ()

    def __init__(self) -> None:
        cls = type(self)
        self.parser: argparse.ArgumentParser | None = None
        self.cli: Cli | None = None
        self.subcommands = [child() for child in cls.children]
        if not self.name:
            self.name = cls.__name__.lower()
        if not self.description:
            self.description = (cls.__doc__ if cls.__doc__ != Command.__doc__ else "") or ""
        if not self.help_text:
            self.help_text = self.description.strip().partition("\n")[0]

    # -- override hooks ----------------------------------------------------

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        r"""Declare this command's own flags on ``parser``."""

    def lineage_arguments(self, parser: argparse.ArgumentParser) -> None:
        r"""Declare flags inherited by every child command."""

    def run(self, ns: argparse.Namespace) -> None:
        r"""Act on the parsed namespace (pure groups leave this untouched)."""

    # -- tree wiring -------------------------------------------------------

    def _overrides(self, hook: str) -> bool:
        return getattr(type(self), hook) is not getattr(Command, hook)

    def attach(self, registry: argparse._SubParsersAction,
               lineage: tuple[argparse.ArgumentParser, ...] = ()) -> None:
        spec = dict(
            name=self.name,
            aliases=list(self.aliases),
            description=paint(self.description, BOLD),
            help=self.help_text or self.description,
            parents=list(lineage),
            formatter_class=CliHelpFormatter,
        )
        self.parser = registry.add_parser(**spec)
        self.arguments(self.parser)
        _retitle_general_options(self.parser, to_back=True)
        if runnable := self._overrides("run"):
            self.parser.set_defaults(invoke=self.run)
        if not self.subcommands:
            return
        table = self.parser.add_subparsers(
            title=paint(f"{self.name} subcommands", BOLD),
            dest=f"{self.name}_subcommand",
            required=not runnable,
        )
        if self._overrides("lineage_arguments"):
            heirloom = argparse.ArgumentParser(add_help=False)
            self.lineage_arguments(heirloom)
            lineage = (*lineage, heirloom)
        for child in self.subcommands:
            child.cli = self.cli
            child.attach(table, lineage)


def main() -> None:
    r"""Entry point for the ``kaptive-tpu-torch`` console script."""
    from kaptive_tpu_torch.db.cli import Database
    from kaptive_tpu_torch.serotyping.cli import Convert, Type

    with Cli(
        description="🦠 kaptive-tpu-torch: in silico serotyping of surface antigen loci on an NVIDIA GPU.",
        epilog="📚 The PyTorch/CUDA port of kaptive-tpu, with the capabilities of Kaptive 3.",
    ) as app:
        for command_cls in (Database, Type, Convert):
            app.mount(command_cls())
        app.dispatch()


if __name__ == "__main__":
    main()
