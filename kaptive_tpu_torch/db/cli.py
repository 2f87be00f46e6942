r"""CLI command tree for database management: ``kaptive-tpu-torch db ...``.

Capability parity with ``kaptive/db/cli.py``: the
``Database`` parent command with ``list``/``available``/``add``/``install``/
``update``/``reset``/``metadata`` and the ``extract`` tree dumping loci/genes/
proteins as FASTA (:28-418).  The simple name-printing, lifecycle, and extract
commands are parameterised bases; the metadata panel is driven by a label
roster rather than unrolled row statements.
"""

from __future__ import annotations

import argparse

from kaptive_tpu_torch.cli import BOLD, BOLD_CYAN, Command, paint


def _manager():
    from kaptive_tpu_torch.db import DatabaseManager

    return DatabaseManager


def _needs_database_arg(parser: argparse.ArgumentParser, helptext: str, **kw) -> None:
    parser.add_argument_group("📥 Inputs").add_argument("database", help=helptext, **kw)


class _PrintNames(Command):
    r"""Prints one database keyword per line from a manager query."""

    query = ""  # DatabaseManager classmethod to call
    none_note = ""  # verbose note when the query comes back empty

    def run(self, ns: argparse.Namespace) -> None:
        if names := getattr(_manager(), self.query)():
            print("\n".join(names))
        else:
            self.cli.msg(self.none_note)


class List(_PrintNames):
    r"""📋 List all currently installed local databases.

    Aliases:
        ls
    """

    aliases = ("ls",)
    query, none_note = "installed", "❌ No databases installed"


class Available(_PrintNames):
    r"""🌐 List all available official databases for installation.

    Aliases:
        avail
    """

    aliases = ("avail",)
    query, none_note = "known", "❌ No available databases found"


class Install(Command):
    r"""📦 Install known reference databases via keyword."""

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        _needs_database_arg(
            parser, "Database keyword (see: `kaptive-tpu-torch db avail`) or 'all'"
        )

    def run(self, ns: argparse.Namespace) -> None:
        target = ns.database
        self.cli.msg(
            "📥 Installing all known databases concurrently..."
            if target == "all"
            else f"📥 Installing database '{target}'..."
        )
        _manager().install(target)
        self.cli.msg(
            "✅ Successfully installed all known databases."
            if target == "all"
            else f"✅ Successfully installed '{target}'."
        )


class Update(Command):
    r"""🔄 Update installed local databases from remote repositories."""

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        _needs_database_arg(
            parser,
            "Database keyword (see: `kaptive-tpu-torch db list`) or 'all' (default: all)",
            nargs="?", default="all",
        )

    def run(self, ns: argparse.Namespace) -> None:
        target = ns.database
        self.cli.msg(
            "🔄 Checking all installed databases for updates concurrently..."
            if target == "all"
            else f"🔄 Checking '{target}' for updates..."
        )
        refreshed = list(_manager().update(target))
        for db in refreshed:
            self.cli.msg(f"✅ Updated {db.metadata.name} to version {db.metadata.version}")
        if not refreshed:
            self.cli.msg("🎉 All databases are already up to date.")


class Reset(Command):
    r"""🧹 Uninstall all local databases and reset local cache."""

    def run(self, ns: argparse.Namespace) -> None:
        self.cli.msg("🧹 Uninstalling all local databases...")
        _manager().reset()
        self.cli.msg("✅ All local databases have been uninstalled and reset.")


class Add(Command):
    r"""🔗 Add a custom reference database from a GitHub repository."""

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        _needs_database_arg(parser, "Name for the new database")
        gh = parser.add_argument_group(paint("🌐 GitHub Details", BOLD))
        gh.add_argument("owner", help="GitHub repository owner")
        gh.add_argument("repo_name", help="GitHub repository name")
        gh.add_argument(
            "-b", "--branch", nargs="?", default="main",
            help="GitHub repository branch (default: main)",
        )

    def run(self, ns: argparse.Namespace) -> None:
        self.cli.msg(f"⤵️ Adding {ns.database} from {ns.owner}/{ns.repo_name}/{ns.branch}")
        db = _manager().add(ns.owner, ns.repo_name, ns.database, ns.branch)
        if db is None:
            self.cli.msg("❌ Failed to add database! Is it already installed?")
        else:
            self.cli.msg(f"✅ Added {db.metadata.name} v{db.metadata.version} successfully!")


class Metadata(Command):
    r"""📊 Print detailed metadata of a reference database.

    Aliases:
        info
    """

    aliases = ("info",)

    # Panel rows in display order; labels not in the computed set project the
    # lower-cased metadata attribute of the same name.
    _PANEL = (
        "Organism", "Taxon", "Antigen", "Pathway", "Version", "Keyword",
        "Threshold", "GenBank", "DOIs", "Repository", "Contact",
    )

    def arguments(self, parser: argparse.ArgumentParser) -> None:
        _needs_database_arg(
            parser, "Database path or keyword (see: `kaptive-tpu-torch db list`)"
        )

    @classmethod
    def _rows(cls, meta) -> list[tuple[str, str]]:
        computed = {
            "Taxon": str(meta.taxon),
            "Threshold": f"{meta.id_threshold}%",
            "DOIs": ", ".join(meta.doi) if meta.doi else "None",
            "Repository": f"https://github.com/{meta.owner}/{meta.repo}/tree/{meta.branch}",
            "Contact": ", ".join(f"{who} <{mail}>" for who, mail in meta.contact.items()),
        }
        return [
            (label, computed[label] if label in computed else getattr(meta, label.lower()))
            for label in cls._PANEL
        ]

    def run(self, ns: argparse.Namespace) -> None:
        meta = _manager().get(ns.database).metadata
        rows = self._rows(meta)
        width = max(len(label) for label, _ in rows)
        body = "\n".join(
            f"  {paint(label.ljust(width), BOLD)}  {value}" for label, value in rows
        )
        print(paint(f"\n📊 Metadata for {meta.name}\n", BOLD_CYAN) + body + "\n")


class _ExtractRecords(Command):
    r"""Shared extract implementation: subclasses name the database record set."""

    record_attr = ""  # Database attribute holding the Sequences batch
    noun = ""  # human label for messages

    def run(self, ns: argparse.Namespace) -> None:
        self.cli.msg(f"💽 Loading database {ns.database}...")
        db = _manager().get(ns.database)
        sink = self.cli.open_file(ns.out, "wb")
        self.cli.msg(f"📤 Extracting {self.noun}...")
        sink.write(getattr(db, self.record_attr).to_fasta(ns.use_indices))
        self.cli.msg(f"✅ Written {self.noun} sequences to {ns.out}.")


class Loci(_ExtractRecords):
    r"""🧬 Extract locus nucleotide sequences in FASTA format."""

    record_attr, noun = "loci", "locus"


class Genes(_ExtractRecords):
    r"""🧩 Extract gene coding sequences in FASTA format."""

    record_attr, noun = "genes", "gene"


class Proteins(_ExtractRecords):
    r"""🧶 Extract translated protein sequences in FASTA format."""

    record_attr, noun = "translations", "protein"


class Extract(Command):
    r"""📤 Extract database records in FASTA format."""

    children = (Loci, Genes, Proteins)

    def lineage_arguments(self, parser: argparse.ArgumentParser) -> None:
        _needs_database_arg(parser, "Database path or keyword (see: `kaptive-tpu-torch db list`)")
        out = parser.add_argument_group("📤 Outputs")
        out.add_argument(
            "-o", "--out", default="-", metavar="FILE",
            help="Output file to write fasta to (default: stdout)",
        )
        out.add_argument(
            "--use-indices", action="store_true",
            help="Use numeric indices instead of string IDs for fasta headers",
        )


class Database(Command):
    r"""📦 Manage local and remote reference databases.

    Aliases:
        db
    """

    aliases = ("db",)
    children = (List, Available, Add, Install, Update, Reset, Extract, Metadata)
