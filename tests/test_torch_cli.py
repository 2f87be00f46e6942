"""The port's command line (``python -m kaptive_tpu_torch.cli``) vs the JAX package's.

``tests/test_cli.py``'s two-genome panel (seed 7: KL1 clean, KL3 1% diverged,
3-locus database).  Each port command runs in a subprocess on the CPU
(``--device cpu``, the kernels' plain versions), most with every ``jax*``
import blocked, and reports the ``jax*`` modules it loaded (none may load).
The reference is computed in the test process, not by a second CLI run: the
JAX ``Serotyper``'s results written by the JAX package's ``ResultExporter``,
and ``Serotyper.screen``'s rows for ``--screen-only``.

Tolerance: exact.  TSV, PHA4GE, JSONL, FASTA and HTML files are byte-equal, in
both seeding modes; so are ``convert``'s outputs, the ``db`` commands' output
and the ``--screen-only`` TSV.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import kaptive_tpu.native.hostio  # noqa: F401  (built here, before any subprocess imports it)

ROOT = Path(__file__).resolve().parent.parent
GENOMES = ["../g1.fasta", "../g2.fasta"]
FULL_OUTPUTS = ["-o", "out.tsv", "-j", "res.jsonl", "--pha4ge", "out.pha4ge",
                "-l", ".", "-g", ".", "-p", ".", "--plots", "."]

BOOT = r"""
import atexit, importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


if sys.argv[1] == "block":
    sys.meta_path.insert(0, BlockJax())


@atexit.register
def _report():
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    sys.stderr.write("\nJAX_MODULES=%s\n" % ",".join(loaded))


sys.argv = ["kaptive-tpu-torch", *sys.argv[2:]]
from kaptive_tpu_torch.cli import main

main()
"""


def run_port(args, cwd: Path, jax: str = "block", **extra_env: str) -> subprocess.CompletedProcess:
    """Run the port's CLI in ``cwd``; asserts that no ``jax*`` module was loaded."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), KAPTIVE_DB_DIR=str(cwd.parent / "cache"), HOME=str(cwd),
               OMP_NUM_THREADS="1", **extra_env)
    cwd.mkdir(exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", BOOT, jax, *args], cwd=cwd, env=env,
                          capture_output=True, timeout=600)
    report = [ln for ln in proc.stderr.decode().splitlines() if ln.startswith("JAX_MODULES=")]
    assert report == ["JAX_MODULES="], proc.stderr.decode()[-3000:]
    return proc


def _outputs(directory: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir()) if p.is_file()}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from synthetic import make_genome_from_locus, make_synthetic_db

    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(7)
    _, truth = make_synthetic_db(tmp, rng, n_loci=3)
    (tmp / "g1.fasta").write_bytes(make_genome_from_locus(rng, truth, "KL1"))
    (tmp / "g2.fasta").write_bytes(make_genome_from_locus(rng, truth, "KL3", sub_rate=0.01))
    return tmp


def _jax_cli(command_cls, argv):
    """The JAX package's parser and ``Cli`` for ``argv`` (nothing is run)."""
    from kaptive_tpu.cli import Cli

    app = Cli()
    command = app.mount(command_cls())
    return app, command, app.parser.parse_args(argv)


@pytest.fixture(scope="module")
def jax_outputs(workdir):
    """Every file the JAX package's ``ResultExporter`` writes for the panel, typed by its ``Serotyper``."""
    from kaptive_tpu.db import Database
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.serotyping.cli import ResultExporter, Type

    ref = workdir / "ref"
    ref.mkdir()
    cwd = Path.cwd()
    os.chdir(ref)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("KAPTIVE_SEED_MODE", "host")
            app, _, ns = _jax_cli(Type, ["type", "../TestDB.gbk", *GENOMES, *FULL_OUTPUTS])
            exporter = ResultExporter(app, ns)
            serotyper = Serotyper(
                Database.from_genbank("../TestDB.gbk"), max_other_genes=ns.max_other_genes,
                min_completeness=ns.min_completeness, allow_below_threshold=ns.below_threshold,
                partial_edge_tolerance=ns.partial_edge_tolerance,
            )
            for result in serotyper.batch(GENOMES):
                exporter(result)
            app.close_files()
    finally:
        os.chdir(cwd)
    return _outputs(ref)


@pytest.fixture(scope="module")
def port_host(workdir):
    """The port's ``type`` host-seeded with every output and ``--profile``: ``(proc, outputs)``."""
    proc = run_port(["type", "../TestDB.gbk", *GENOMES, *FULL_OUTPUTS, "--device", "cpu",
                     "--seed-mode", "host", "--profile"], workdir / "port_host")
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    return proc, _outputs(workdir / "port_host")


def test_type_host_seeded_equals_jax(port_host, jax_outputs):
    _, got = port_host
    assert sorted(got) == sorted(jax_outputs) == sorted(
        ["out.tsv", "res.jsonl", "out.pha4ge"]
        + [f"g{i}_kaptive_results.{ext}" for i in (1, 2) for ext in ("fna", "ffn", "faa", "html")]
    )
    for name, want in jax_outputs.items():
        assert got[name] == want, name
    rows = got["out.tsv"].splitlines()
    assert [r.split(b"\t")[4] for r in rows[1:]] == [b"KL1", b"KL3"]


def test_type_device_seeded_equals_jax(workdir, jax_outputs):
    proc = run_port(["type", "../TestDB.gbk", *GENOMES, *FULL_OUTPUTS, "--device", "cpu",
                     "--seed-mode", "device", "--batch-size", "1", "-t", "2"], workdir / "port_device")
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    got = _outputs(workdir / "port_device")
    assert got.keys() == jax_outputs.keys()
    for name, want in jax_outputs.items():
        assert got[name] == want, name


def test_profile_prints_phase_table(port_host):
    proc, _ = port_host
    err = proc.stderr.decode()
    assert "phase timings:" in err and "pipeline counters:" in err
    for name in ("type.map", "map.extension_dp", "type.protein_dp", "swg.plain.fill", "swg.plain.traceback"):
        assert name in err, name
    assert "swg.cuda" not in err


def test_convert_round_trip(workdir, port_host):
    _, typed = port_host
    proc = run_port(["convert", "../port_host/res.jsonl", "-t", "conv.tsv", "--pha4ge", "conv.pha4ge"],
                    workdir / "convert")
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    assert (workdir / "convert" / "conv.tsv").read_bytes() == typed["out.tsv"]
    assert (workdir / "convert" / "conv.pha4ge").read_bytes() == typed["out.pha4ge"]


@pytest.mark.parametrize(("argv", "marker"), [(["db", "extract", "loci", "../TestDB.gbk"], b">KL1"),
                                              (["db", "metadata", "../TestDB.gbk"], b"Testus syntheticus")],
                         ids=["extract-loci", "metadata"])
def test_db_commands_through_port_root(workdir, argv, marker, capsysbinary, monkeypatch):
    from kaptive_tpu.db.cli import Database as DbCommand

    got = run_port(argv, workdir / "db")
    assert got.returncode == 0, got.stderr.decode()[-3000:]
    monkeypatch.chdir(workdir / "db")
    app, _, ns = _jax_cli(DbCommand, argv)
    ns.invoke(ns)
    sys.stdout.flush()
    want = capsysbinary.readouterr().out
    assert got.stdout == want and marker in want


def test_type_keyword_database(workdir, port_host, monkeypatch):
    """An installed database, by keyword: its pickle loads without jax."""
    from kaptive_tpu.db import Database, DatabaseManager

    monkeypatch.setenv("KAPTIVE_DB_DIR", str(workdir / "cache"))
    db = Database.from_genbank(workdir / "TestDB.gbk")
    DatabaseManager.save(db)
    assert DatabaseManager.installed() == [db.metadata.keyword]
    proc = run_port(["type", db.metadata.keyword, GENOMES[1], "-o", "kw.tsv", "--device", "cpu"],
                    workdir / "keyword")
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    rows = port_host[1]["out.tsv"].splitlines()
    assert (workdir / "keyword" / "kw.tsv").read_bytes().splitlines() == [rows[0], rows[2]]


def test_precompile_and_trace_dir(workdir, port_host):
    """``--precompile`` warms up (``Serotyper.warmup``) before typing; ``$KAPTIVE_TRACE_DIR``
    gets a torch.profiler Chrome trace, and neither loads jax."""
    import json

    cwd = workdir / "precompile"
    proc = run_port(["type", "../TestDB.gbk", GENOMES[0], "-o", "out.tsv", "--device", "cpu",
                     "--precompile", "--batch-size", "1", "-V"], cwd, KAPTIVE_TRACE_DIR="trace")
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    assert "Warm-up done in" in proc.stderr.decode()
    rows = port_host[1]["out.tsv"].splitlines()
    assert (cwd / "out.tsv").read_bytes().splitlines() == rows[:2]
    (trace,) = (cwd / "trace").glob("kaptive_trace_*.json")
    assert len(json.loads(trace.read_bytes())["traceEvents"]) > 0


def test_screen_only_equals_jax(workdir):
    from kaptive_tpu.db import Database
    from kaptive_tpu.serotyping import Serotyper

    # jax importable here: the port must still not load it.
    proc = run_port(["type", "../TestDB.gbk", *GENOMES, "--screen-only", "-o", "screen.tsv",
                     "--device", "cpu"], workdir / "screen", jax="allow")
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    db = Database.from_genbank(workdir / "TestDB.gbk")
    cwd = Path.cwd()
    os.chdir(workdir / "screen")
    try:
        assemblies, best, weighted = Serotyper(db).screen(GENOMES)
    finally:
        os.chdir(cwd)
    want = b"Assembly\tBest match locus\tScore\n" + b"".join(
        b"%s\t%s\t%.2f\n" % (ga.id.encode(), db.loci.ids[int(b)].encode(), weighted[i, int(b)])
        for i, (ga, b) in enumerate(zip(assemblies, best))
    )
    got = (workdir / "screen" / "screen.tsv").read_bytes()
    assert got == want
    assert [ln.split(b"\t")[1] for ln in got.splitlines()[1:]] == [b"KL1", b"KL3"]


def test_screen_only_rejects_other_outputs(workdir):
    proc = run_port(["type", "../TestDB.gbk", *GENOMES, "--screen-only", "-j", "x.jsonl", "--plots", ".",
                     "--device", "cpu"], workdir / "screen_conflict")
    assert proc.returncode == 2
    assert b"--screen-only writes only the 3-column triage TSV; remove --json, --plots" in proc.stderr
    assert not (workdir / "screen_conflict" / "x.jsonl").exists()


def test_help_speaks_of_the_port(workdir):
    proc = run_port(["type", "--help"], workdir / "help")
    assert proc.returncode == 0
    text = proc.stdout.decode()
    assert "--device" in text and "torch.profiler" in text
    for word in ("jax", "XLA", "Pallas"):
        assert word not in text, word


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_device_cuda_without_a_card_fails(workdir):
    proc = run_port(["type", "../TestDB.gbk", GENOMES[0], "-o", "never.tsv"], workdir / "no_card")
    assert proc.returncode == 1
    assert b"no CUDA device" in proc.stderr
    assert not (workdir / "no_card" / "never.tsv").exists()
