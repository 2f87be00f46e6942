"""The port stands alone: it imports nothing of ``kaptive_tpu`` and never ``jax``.

A subprocess imports the port, makes a database with the port's own GenBank
writer, types one small genome on the CPU in host- and in device-seeded mode,
runs the port's command line (``type``, ``convert`` and ``db``) on it,
annotates it with the BGC toolkit (gene HMM, aligned hits), trains an
architectural model on the database's loci and predicts on it, types the genome again on a
two-slot CPU mesh (``parallel.mesh``, ``parallel.typing``, the sharded screen) and loads
``parallel.multihost``, and checks that no ``kaptive_tpu``, ``kaptive_tpu.*`` or ``jax*`` module is in
``sys.modules`` — once with every such import blocked in the meta-path finder
(a machine that has neither) and once with all of them importable (as on the
GPU machine, where jax and the JAX package are installed but must stay
unused).  A static test reads every source file of the port and
``chip_smoke.py`` for an import statement that names either, and checks that
the port has every module of the JAX package's ``bgc`` and ``parallel`` packages.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import contextlib, importlib.abc, io, json, os, shutil, sys, tempfile
from pathlib import Path

FOREIGN = ("jax", "jaxlib", "kaptive_tpu")


class BlockForeign(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


if sys.argv[2] == "block":
    sys.meta_path.insert(0, BlockForeign())
sys.path.insert(0, sys.argv[1])

import numpy as np
import torch
from torch_synthetic import make_genome_from_locus, make_synthetic_db

torch.set_num_threads(1)  # the test runs beside other test processes

import kaptive_tpu_torch.ops.swg_cuda  # noqa: F401  (the bindings import without a build)
import kaptive_tpu_torch.ops.scan_cuda  # noqa: F401
import kaptive_tpu_torch.ops.viterbi_cuda  # noqa: F401
from kaptive_tpu_torch.core.genome import GenomeAssembly
from kaptive_tpu_torch.db import Database
from kaptive_tpu_torch.parallel import stream_type
from kaptive_tpu_torch.serotyping import KaptiveRow, Serotyper

rng = np.random.default_rng(17)
tmp = Path(tempfile.mkdtemp())
gbk, truth = make_synthetic_db(tmp, rng, n_loci=3, genes_per_locus=4)
db = Database.from_genbank(gbk)
fasta = make_genome_from_locus(rng, truth, "KL2")
serotyper = Serotyper(db, device="cpu")
result = serotyper(GenomeAssembly.from_stream(io.BytesIO(fasta), "g"))
streamed = list(stream_type(serotyper, [io.BytesIO(fasta)], batch_size=1))
row = bytes(KaptiveRow.from_result(result))
os.environ["KAPTIVE_SEED_MODE"] = "device"
device_rows = [bytes(KaptiveRow.from_result(r)) for r in
               [serotyper(GenomeAssembly.from_stream(io.BytesIO(fasta), "g")),
                *stream_type(serotyper, [io.BytesIO(fasta)], batch_size=1)]]
del os.environ["KAPTIVE_SEED_MODE"]

from kaptive_tpu_torch.cli import main

(tmp / "g.fasta").write_bytes(fasta)
sys.argv = ["kaptive-tpu-torch", "type", str(gbk), str(tmp / "g.fasta"), "-o", str(tmp / "out.tsv"),
            "-j", str(tmp / "out.jsonl"), "--device", "cpu"]
main()
cli_rows = (tmp / "out.tsv").read_bytes().splitlines()[1:]
sys.argv = ["kaptive-tpu-torch", "convert", str(tmp / "out.jsonl"), "-t", str(tmp / "conv.tsv")]
main()
converted = (tmp / "conv.tsv").read_bytes().splitlines()[1:] == cli_rows
sys.argv = ["kaptive-tpu-torch", "db", "metadata", str(gbk)]
shown = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
with contextlib.redirect_stdout(shown):
    main()
shown.flush()
db_metadata = b"Testus syntheticus" in shown.buffer.getvalue()
shutil.rmtree(tmp)

from kaptive_tpu_torch.bgc import Annotator, ArchitecturalPredictor, ArchitecturalTrainer

annotation = Annotator(db, align=True, device="cpu")(GenomeAssembly.from_stream(io.BytesIO(fasta), "g"))
model = ArchitecturalTrainer(num_archetypes=3, feature_dim=128).train(
    [db.get_locus_data(name) for name in ("KL1", "KL2", "KL3")])
predicted = ArchitecturalPredictor(model, device="cpu").predict(annotation)
bgc_hits = sum("KL2" in str(name) for name in annotation.top_hit_names[annotation.hits_mask])

import kaptive_tpu_torch.parallel.multihost  # noqa: F401
from kaptive_tpu_torch.parallel import make_mesh

mesh_serotyper = Serotyper(db, mesh=make_mesh(devices=[torch.device("cpu")] * 2, model_parallel=2))
mesh_row = bytes(KaptiveRow.from_result(mesh_serotyper(GenomeAssembly.from_stream(io.BytesIO(fasta), "g"))))
mesh_screen = mesh_serotyper.screen([GenomeAssembly.from_stream(io.BytesIO(fasta), "g")])[1].tolist()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
print(json.dumps({"locus": result.best_locus_name, "streamed": streamed[0].best_locus_name,
                  "row_bytes": len(row), "device_rows_equal": device_rows == [row, bytes(KaptiveRow.from_result(streamed[0]))],
                  "cli_rows_equal": cli_rows == row.splitlines(), "converted": converted,
                  "db_metadata": db_metadata, "bgc_genes": len(annotation.genes), "bgc_hits": bgc_hits,
                  "bgc_aligned": annotation.alignments is not None, "bgc_loci": len(predicted),
                  "mesh_row_equal": mesh_row == row, "mesh_screen": [db.loci.ids[b] for b in mesh_screen],
                  "foreign_modules": loaded}))
"""


@pytest.mark.parametrize("jax_import", ["block", "allow"])
def test_port_types_without_jax(jax_import):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT / "tests"), jax_import],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["foreign_modules"] == []
    assert out["locus"] == "KL2" and out["streamed"] == "KL2"
    assert out["row_bytes"] > 0
    assert out["device_rows_equal"]
    assert out["cli_rows_equal"] and out["converted"] and out["db_metadata"]
    assert out["bgc_genes"] > 0 and out["bgc_hits"] > 0 and out["bgc_aligned"]
    assert out["mesh_row_equal"] and out["mesh_screen"] == ["KL2"]


_FOREIGN_IMPORT = re.compile(r"^\s*(from|import) +(kaptive_tpu|jax|jaxlib)(\.|\s|$)", re.M)


def test_no_source_file_imports_the_jax_package():
    sources = [*sorted((ROOT / "kaptive_tpu_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    assert len(sources) > 40
    for package in ("bgc", "parallel"):  # every module of the BGC toolkit and of the parallel package
        ported = {p.name for p in sources if p.parent.name == package}
        assert ported == {p.name for p in (ROOT / "kaptive_tpu" / package).glob("*.py")}, package
    offenders = {str(p.relative_to(ROOT)): _FOREIGN_IMPORT.findall(p.read_text()) for p in sources}
    assert {name: hits for name, hits in offenders.items() if hits} == {}
    assert not (ROOT / "kaptive_tpu_torch" / "_reuse.py").exists()
