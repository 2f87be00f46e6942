r"""Helpers of the benchmark's CPU tests: a copy of the benchmark with a tiny cell added as files.

The tiny configuration and mixes live here, not under ``configs/`` and
``traffic/``; ``tiny_root`` writes them into a temporary copy of the
benchmark beside a ``BENCHMARK.json`` that names them, which is how a later
change adds a cell.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "name": "tiny", "db_name": "Tiny_K_locus_synthetic", "organism": "Testus syntheticus", "taxon": 12345,
    "n_loci": 6, "genes_per_locus": 6, "gene_nt": [300, 900], "spacer_nt": [80, 200], "tail_nt": 150,
    "families_5p": ["galF", "wzc"], "families_3p": ["gnd"], "family_identity": [0.80, 0.99],
    "genome_nt": 40000, "id_threshold": 82.5,
}
MIX = [
    {"name": "clean", "weight": 1, "sub_rate": 0.0, "contigs": [1, 1], "split": "none"},
    {"name": "diverged", "weight": 1, "sub_rate": 0.01, "contigs": [1, 1], "split": "none"},
    {"name": "fragmented", "weight": 1, "sub_rate": 0.0, "contigs": [2, 2], "split": "at_locus_middle"},
    {"name": "draft", "weight": 1, "sub_rate": 0.005, "contigs": [3, 6], "split": "random", "min_contig_nt": 1000},
]
ENV = {"KAPTIVE_SEED_MODE": "auto"}
TINY_TRAFFIC = {
    "tiny_stream": {"entry": "stream", "env": ENV, "batch_size": 4, "pool_size": 8, "check_sample": 8, "classes": MIX},
    "tiny_single": {"entry": "single", "env": ENV, "pool_size": 8, "check_sample": 8, "classes": MIX},
}


def make_tiny_root(tmp: Path) -> Path:
    r"""A checkout-like directory: the benchmark copied, the tiny cells added as files."""
    shutil.copytree(BENCH, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, mix in TINY_TRAFFIC.items():
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a CPU test"})
    for cell, traffic in (("tiny.stream", "tiny_stream"), ("tiny.single", "tiny_single")):
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic, "chips": 1, "why": "a CPU test"})
    adds = {"asm_per_s": ["tiny.stream", "tiny.single"], "asm_p95_ms": ["tiny.single"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += adds.get(m["name"], ["tiny.single"] if m["name"].endswith(".single") else [])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
