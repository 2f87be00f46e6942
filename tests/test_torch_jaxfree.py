"""The port never imports jax: a subprocess imports the port, types one small genome
on the CPU in host- and in device-seeded mode, runs the port's command line
(``kaptive_tpu_torch.cli.main``) on it and checks that no ``jax*`` module was
loaded — once with every
``jax*`` import blocked (a machine without jax) and once with jax importable
(as on the GPU machine, where jax is installed but must stay unused).  In that
process the names the JAX package's ``kaptive_tpu.serotyping`` re-exports from
its jax-free modules (``KaptiveRow``, ``SerotypingResult``, ...) import as the
port's, and its ``Serotyper`` raises an ImportError that names the cause."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib.abc, io, json, os, shutil, sys, tempfile
from pathlib import Path


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


if sys.argv[2] == "block":
    sys.meta_path.insert(0, BlockJax())
sys.path.insert(0, sys.argv[1])

import numpy as np
import torch
from synthetic import make_genome_from_locus, make_synthetic_db

torch.set_num_threads(1)  # the test runs beside other test processes

import kaptive_tpu_torch.ops.swg_cuda  # noqa: F401  (first; the bindings import without a build)
import kaptive_tpu_torch.ops.scan_cuda  # noqa: F401
from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.db import Database
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
try:
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper  # noqa: F401
    skipped_init = None
except ImportError as err:
    skipped_init = str(err)
from kaptive_tpu.serotyping import KaptiveRow as BareRow, SerotypingResult as BareResult
from kaptive_tpu_torch.serotyping import SerotypingResult
reexports = BareRow is KaptiveRow and BareResult is SerotypingResult

from kaptive_tpu_torch.cli import main

(tmp / "g.fasta").write_bytes(fasta)
sys.argv = ["kaptive-tpu-torch", "type", str(gbk), str(tmp / "g.fasta"), "-o", str(tmp / "out.tsv"),
            "-j", str(tmp / "out.jsonl"), "--device", "cpu"]
main()
cli_rows = (tmp / "out.tsv").read_bytes().splitlines()[1:]
sys.argv = ["kaptive-tpu-torch", "convert", str(tmp / "out.jsonl"), "-t", str(tmp / "conv.tsv")]
main()
converted = (tmp / "conv.tsv").read_bytes().splitlines()[1:] == cli_rows
shutil.rmtree(tmp)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
print(json.dumps({"locus": result.best_locus_name, "streamed": streamed[0].best_locus_name,
                  "row_bytes": len(row), "device_rows_equal": device_rows == [row, bytes(KaptiveRow.from_result(streamed[0]))],
                  "skipped_init": skipped_init, "reexports": reexports,
                  "cli_rows_equal": cli_rows == row.splitlines(), "converted": converted, "jax_modules": loaded}))
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
    assert out["jax_modules"] == []
    assert out["locus"] == "KL2" and out["streamed"] == "KL2"
    assert out["row_bytes"] > 0
    assert out["device_rows_equal"]
    # The JAX package's own entry points say why they are missing.
    assert "kaptive_tpu_torch loaded 'kaptive_tpu.serotyping' as a bare package" in out["skipped_init"]
    # ... and the writers' row classes are there, so the CLI's writers work.
    assert out["reexports"]
    assert out["cli_rows_equal"] and out["converted"]
