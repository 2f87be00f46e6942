r"""Helpers of the benchmark's CPU tests: a copy of the benchmark with tiny cells added as files.

The tiny configurations (one K-shaped, one O-shaped with extra genes and
phenotype rules) and their mixes live here, not under ``configs/`` and
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

# O-shaped: loci that share most of their genes (two nearly identical), genes outside the locus
# that a replacement rule asks for, and a rule on a gene knocked out.
TINY_O_CONFIG = {
    "name": "tiny_o", "db_name": "Tiny_O_locus_synthetic", "organism": "Testus syntheticus", "taxon": 12345,
    "antigen": "Lipopolysaccharide O antigen", "pathway": "ABC transporter-dependent",
    "gene_nt": [300, 900], "spacer_nt": [80, 200], "tail_nt": 150,
    "family_identity": [0.80, 0.99], "cluster_identity": {"glf": [0.99, 0.999], "wbbM": [0.99, 0.999]},
    "loci": [
        {"name": "OL1", "type": "O1", "genes": ["wzm", "wzt", "wbbM", "glf", "wbbN", "wbbO"]},
        {"name": "OL2.1", "type": "O2a", "genes": ["wzm", "wzt", "wbbM", "glf", "wbbN", "wbbO", "gmlA"]},
        {"name": "OL2.2", "type": "O2b", "genes": ["wzm", "wzt", "wbbM", "glf", "wbbN", "wbbO", "gmlB"]},
        {"name": "OL3", "type": "O3", "genes": ["wzm", "wzt", "wbdA", "wbdB", "wbdC", "wbdD"]},
    ],
    "extra_genes": [{"cluster": "wbbY", "nt": 900}, {"cluster": "wbbZ", "nt": 600}],
    "phenotype_logic": {
        "O1v2": {"loci": ["OL2.*"], "extra_genes": ["wbbY", "wbbZ"], "priority": 60},
        "O-null": {"loci": ["OL*"], "inactive_genes": ["wzm"], "priority": 100},
    },
    "genome_nt": 40000, "id_threshold": 82.5,
}
O_PLANTS = {"extra_sets": [{"genes": ["wbbY", "wbbZ"], "share": 0.5}], "knockout": {"cluster": "wzm", "share": 0.25}}
O_MIX = [
    {"name": "clean", "weight": 1, "sub_rate": 0.0, "contigs": [1, 1], "split": "none", **O_PLANTS},
    {"name": "draft", "weight": 1, "sub_rate": 0.005, "contigs": [3, 6], "split": "random", "min_contig_nt": 1000,
     **O_PLANTS},
]
TINY_O_TRAFFIC = {"entry": "single", "env": ENV, "pool_size": 8, "check_sample": 8, "classes": O_MIX}


def make_tiny_root(tmp: Path) -> Path:
    r"""A checkout-like directory: the benchmark copied, the tiny cells added as files."""
    shutil.copytree(BENCH, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, config in (("tiny", TINY_CONFIG), ("tiny_o", TINY_O_CONFIG)):
        (tmp / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(config))
    for name, mix in {**TINY_TRAFFIC, "tiny_o_single": TINY_O_TRAFFIC}.items():
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("tiny", "tiny_o"):
        spec["configs"].append({"name": name, "source": "https://example.org/tiny", "why": "a CPU test",
                                "file": f"benchmark/configs/{name}.json", "reduced": []})
    singles = ["tiny.single", "tiny_o.single"]
    for cell, config, traffic in (("tiny.stream", "tiny", "tiny_stream"), ("tiny.single", "tiny", "tiny_single"),
                                  ("tiny_o.single", "tiny_o", "tiny_o_single")):
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "a CPU test"})
    adds = {"asm_per_s": ["tiny.stream", *singles], "asm_p95_ms": singles}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += adds.get(m["name"], singles if m["name"].endswith(".single") else [])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return tmp


@pytest.fixture(autouse=True)
def _one_thread():
    r"""One intra-op thread, as the cells' mixes set for the card: the plain CPU forms of the kernels
    run faster on one, and test workers do not contend for the cores, so a window holds requests."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
