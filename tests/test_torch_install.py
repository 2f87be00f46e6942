"""The port as users install it: a wheel built from the repository, installed apart from the checkout.

The files git would commit are copied to ``tmp_path`` (``git ls-files``:
tracked and untracked, without what ``.gitignore`` lists; outside a git
checkout, the package trees without caches), a wheel is built
from the copy offline (``pip wheel --no-deps --no-build-isolation
--no-index``) and installed with ``--target`` into a directory outside the
checkout.  ``python -m kaptive_tpu_torch.cli type ... --device cpu`` then
runs from a ``cwd`` outside the checkout, with ``PYTHONPATH`` naming only the
installed copy, ``XDG_CACHE_HOME`` and ``HOME`` in ``tmp_path`` and every
``jax*`` and ``kaptive_tpu`` import blocked.  It must build the host library
in the per-user cache from the installed ``hostio.cpp``, resolve every CUDA
source inside the installed package, and write the JAX package's TSV rows.

Panel: ``tests/test_cli.py``'s (seed 7: KL1 clean, KL3 1% diverged, a
3-locus database).  Tolerance: the TSV is byte-equal.  The tests skip only
where setuptools is missing, which building a wheel offline needs.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SHIPPED = ("pyproject.toml", "README.md", "kaptive_tpu/", "kaptive_tpu_torch/")

RUN = r"""
import atexit, importlib.abc, json, sys

FOREIGN = ("jax", "jaxlib", "kaptive_tpu")


class BlockForeign(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


sys.meta_path.insert(0, BlockForeign())


@atexit.register
def _report():
    import kaptive_tpu_torch
    from kaptive_tpu_torch.native import hostio
    from kaptive_tpu_torch.ops import scan_cuda, swg_cuda, viterbi_cuda

    sys.stderr.write("\nINSTALL=" + json.dumps({
        "package": kaptive_tpu_torch.__file__,
        "hostio_source": str(hostio.SOURCE), "hostio_library": str(hostio.LIBRARY),
        "cuda_sources": [str(m.LIBRARY.source) for m in (scan_cuda, swg_cuda, viterbi_cuda)],
        "cuda_libraries": [str(m.LIBRARY.library) for m in (scan_cuda, swg_cuda, viterbi_cuda)],
        "foreign": sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN),
    }) + "\n")


sys.argv = ["kaptive-tpu-torch", *sys.argv[1:]]
from kaptive_tpu_torch.cli import main

main()
"""


def _committed_copy(dest: Path) -> Path:
    r"""The files git would commit under :data:`SHIPPED`, copied to ``dest``; outside a git
    checkout, the same trees without caches and built libraries."""
    try:
        listed = subprocess.run(
            ["git", "-C", str(ROOT), "ls-files", "-z", "--cached", "--others", "--exclude-standard", "--",
             *SHIPPED], check=True, capture_output=True, timeout=120,
        ).stdout.decode().split("\0")
    except (OSError, subprocess.CalledProcessError):
        skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.tmp")
        for rel in SHIPPED:
            if rel.endswith("/"):
                shutil.copytree(ROOT / rel, dest / rel, ignore=skip)
            else:
                dest.mkdir(parents=True, exist_ok=True)
                shutil.copy2(ROOT / rel, dest / rel)
        return dest
    for rel in filter(None, listed):
        src = ROOT / rel
        if src.is_file():
            (dest / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src, dest / rel)
    return dest


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    r"""``(wheel path, --target directory)`` of the port built from the committed files."""
    if importlib.util.find_spec("setuptools") is None:
        pytest.skip("setuptools is missing: a wheel cannot be built offline without build isolation")
    tmp = tmp_path_factory.mktemp("install")
    src = _committed_copy(tmp / "src")
    pip = [sys.executable, "-m", "pip"]
    subprocess.run([*pip, "wheel", str(src), "--no-deps", "--no-build-isolation", "--no-index",
                    "-q", "-w", str(tmp / "wheel")], check=True, capture_output=True, timeout=300)
    (wheel,) = (tmp / "wheel").glob("*.whl")
    site = tmp / "site"
    subprocess.run([*pip, "install", "--no-deps", "--no-index", "-q", "--target", str(site), str(wheel)],
                   check=True, capture_output=True, timeout=300)
    return wheel, site


def test_wheel_ships_every_kernel_source(installed):
    wheel, site = installed
    names = set(zipfile.ZipFile(wheel).namelist())
    sources = sorted(p.name for p in (ROOT / "kaptive_tpu_torch" / "csrc").iterdir() if p.suffix in (".cu", ".cpp"))
    assert {"swg.cu", "scan.cu", "viterbi.cu", "hostio.cpp"} <= set(sources)
    for name in sources:
        assert f"kaptive_tpu_torch/csrc/{name}" in names, name
        assert (site / "kaptive_tpu_torch" / "csrc" / name).is_file(), name


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    from synthetic import make_genome_from_locus, make_synthetic_db

    tmp = tmp_path_factory.mktemp("install_panel")
    rng = np.random.default_rng(7)
    _, truth = make_synthetic_db(tmp, rng, n_loci=3)
    (tmp / "g1.fasta").write_bytes(make_genome_from_locus(rng, truth, "KL1"))
    (tmp / "g2.fasta").write_bytes(make_genome_from_locus(rng, truth, "KL3", sub_rate=0.01))
    return tmp


def _jax_tsv(panel: Path, out: Path) -> bytes:
    r"""The JAX package's ``type -o`` TSV of the panel, written by its ``ResultExporter``."""
    from kaptive_tpu.cli import Cli
    from kaptive_tpu.db import Database
    from kaptive_tpu.serotyping import Serotyper
    from kaptive_tpu.serotyping.cli import ResultExporter, Type

    app = Cli()
    app.mount(Type())
    genomes = [str(panel / "g1.fasta"), str(panel / "g2.fasta")]
    ns = app.parser.parse_args(["type", str(panel / "TestDB.gbk"), *genomes, "-o", str(out)])
    exporter = ResultExporter(app, ns)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAPTIVE_SEED_MODE", "host")
        for result in Serotyper(Database.from_genbank(panel / "TestDB.gbk")).batch(genomes):
            exporter(result)
    app.close_files()
    return out.read_bytes()


def test_installed_type_builds_in_the_user_cache_and_equals_jax(installed, panel, tmp_path):
    _, site = installed
    cwd, cache, home = tmp_path / "run", tmp_path / "cache", tmp_path / "home"
    for d in (cwd, home):
        d.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(cache), HOME=str(home), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", RUN, "type", str(panel / "TestDB.gbk"), str(panel / "g1.fasta"),
         str(panel / "g2.fasta"), "--device", "cpu", "-o", "out.tsv"],
        cwd=cwd, env=env, capture_output=True, timeout=600,
    )
    err = proc.stderr.decode()
    assert proc.returncode == 0, err[-3000:]
    (line,) = [ln for ln in err.splitlines() if ln.startswith("INSTALL=")]
    report = json.loads(line.removeprefix("INSTALL="))
    package = site / "kaptive_tpu_torch"
    assert report["foreign"] == []
    assert Path(report["package"]) == package / "__init__.py"
    assert Path(report["hostio_source"]) == package / "csrc" / "hostio.cpp"
    for source in report["cuda_sources"]:
        assert Path(source).parent == package / "csrc" and Path(source).is_file(), source
    built = cache / "kaptive_tpu_torch"
    assert Path(report["hostio_library"]) == built / "libkaptive_hostio.so"
    assert (built / "libkaptive_hostio.so").is_file()
    assert all(Path(lib).parent == built for lib in report["cuda_libraries"])
    assert not (site / "build").exists() and not (tmp_path / "build").exists()
    got = (cwd / "out.tsv").read_bytes()
    assert got == _jax_tsv(panel, tmp_path / "jax.tsv")
    assert [r.split(b"\t")[4] for r in got.splitlines()[1:]] == [b"KL1", b"KL3"]


def test_checkout_builds_beside_the_package():
    from kaptive_tpu_torch.utils.nvcc import BUILD_DIR, CSRC, build_dir

    assert BUILD_DIR == build_dir() == ROOT / "build" / "kaptive_tpu_torch"
    assert CSRC == ROOT / "kaptive_tpu_torch" / "csrc"
