r"""Phenotype rules and extra genes: the reference's rule engine on hand-written cases, and the
O-shaped tiny cell on the CPU, read correct, and read not correct under each planted fault."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import BENCH, TINY_O_CONFIG, TINY_O_TRAFFIC

from kbench import gen
from kbench.harness import run_cell
from reference.phenotype import phenotype, rules_of

# A seed whose pool holds, among its first three entries, one on which each rule fires.
SEED = 2**31 + 112
CLUSTERS = {"wza", "wzb", "wzc", "wcaJ", "wcaJ2", "gmlA", "gmlB", "rmlB"}


def _phenotype(table, locus, active, expected=("wza", "wzb", "wzc", "wcaJ"), base="K1"):
    return phenotype(rules_of(table), locus, base, CLUSTERS, set(expected), set(active))


def test_patterns_are_fnmatch_wildcards_on_loci_and_clusters():
    table = {"null": {"loci": ["KL?"], "inactive_genes": ["wcaJ*"]}}
    assert _phenotype(table, "KL1", {"wza", "wzb", "wzc"}) == "null"  # wcaJ missing
    assert _phenotype(table, "KL12", {"wza", "wzb", "wzc"}) == "K1"  # ``?`` is one character
    assert _phenotype(table, "KL1", {"wza", "wzb", "wzc", "wcaJ"}) == "K1"
    assert _phenotype({"b": {"loci": ["KL[12]"], "extra_genes": ["gml?"]}}, "KL2", {"gmlA", "gmlB"}) == "b"
    assert _phenotype({"b": {"loci": ["KL[12]"], "extra_genes": ["gml?"]}}, "KL2", {"gmlA"}) == "K1"
    assert _phenotype({"b": {"loci": ["KL[12]"], "extra_genes": ["gml?"]}}, "KL3", {"gmlA", "gmlB"}) == "K1"
    assert _phenotype({"b": {"loci": ["kl1"]}}, "KL1", set()) == "K1"  # case-sensitive


def test_inactive_genes_count_only_those_the_locus_holds():
    table = {"null": {"loci": ["KL*"], "inactive_genes": ["rmlB", "wzc"]}}
    assert _phenotype(table, "KL1", {"wza", "wzb", "wzc", "wcaJ"}) == "K1"  # rmlB inactive, not in the locus
    assert _phenotype(table, "KL1", {"wza", "wzb", "wcaJ"}) == "null"
    # Patterns that match no cluster name no condition.
    assert _phenotype({"x": {"loci": ["KL1"], "inactive_genes": ["nope*"], "extra_genes": ["none"]}}, "KL1",
                      set()) == "x"


def test_the_highest_priority_replaces_and_the_first_wins_a_tie():
    table = {
        "a": {"loci": ["KL1"], "priority": 40},
        "b": {"loci": ["KL*"], "priority": 70},
        "c": {"loci": ["KL1"], "priority": 70},
    }
    assert _phenotype(table, "KL1", set()) == "b"
    assert _phenotype({"a": {"loci": ["KL1"]}, "b": {"loci": ["KL1"], "priority": 50}}, "KL1", set()) == "a"
    assert _phenotype({"a": {"loci": ["KL2"], "priority": 90}}, "KL1", set()) == "K1"


def test_suffixes_append_in_descending_priority_in_table_order_on_ties():
    table = {
        "+x": {"loci": ["KL1"], "as_suffix": True, "priority": 10},
        "+y": {"loci": ["KL1"], "as_suffix": True, "priority": 30},
        "+z": {"loci": ["KL1"], "as_suffix": True, "priority": 10},
        "R": {"loci": ["KL1"], "extra_genes": ["gmlA"], "priority": 5},
    }
    assert _phenotype(table, "KL1", set()) == "K1+y+x+z"
    assert _phenotype(table, "KL1", {"gmlA"}) == "R+y+x+z"  # suffixes follow the replacement


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [%r]; import reference.phenotype, reference.judge; "
        "print(sorted({m.split('.')[0] for m in sys.modules if m.startswith('kaptive')}))"
    ) % str(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def _pool(seed: int):
    from reference.phenotype import expected_phenotypes

    rng_db, rng_pool, _ = gen.seed_streams(seed, 3)
    db = gen.make_database(TINY_O_CONFIG, rng_db)
    pool = gen.make_pool(TINY_O_TRAFFIC, db, TINY_O_CONFIG["genome_nt"], rng_pool)
    return db, pool, expected_phenotypes(pool, db, TINY_O_CONFIG)


def test_the_o_shaped_cell_is_correct_and_each_rule_fires(tiny_root):
    _, pool, want = _pool(SEED)
    assert {"O1v2", "O-null"} <= set(want[:3]) and {"O1v2", "O-null"} < set(want)
    # Long enough on the CPU for the window to reach every entry of the pool.
    out = run_cell(tiny_root, "tiny_o.single", SEED, 30.0, False, "cpu", time.perf_counter())
    assert out.line["attempted"] >= len(pool), out.notes
    assert out.line["correct"], out.notes
    assert all(v == 0 for v, _ in out.checks.values())
    judged = {want[int(asm.name[1:])] for asm, *_ in out.checked}
    assert {"O1v2", "O-null"} <= judged
    assert any(asm.extras for asm, *_ in out.checked) and any(asm.knocked for asm, *_ in out.checked)


def _engine_left_out(monkeypatch):
    r"""Every assembly gets its locus's type: the phenotype rules are never applied."""
    from kaptive_tpu_torch.serotyping import core

    monkeypatch.setattr(core, "resolve_phenotypes", lambda db, best, active: [db.serotypes[int(i)] for i in best])


def _extra_hits_dropped(monkeypatch):
    r"""The mapping step returns no alignment of an extra gene."""
    from kaptive_tpu_torch.serotyping import core

    real = core.Serotyper.map_batch

    def map_batch(self, genomes, indexes=None):
        assemblies, alns = real(self, genomes, indexes)
        extra = np.flatnonzero(self._db.extra_genes)  # an alignment's query is named by its gene's index
        return assemblies, [a[~np.isin(np.asarray(a.q_names_dict, dtype=np.int64)[a.q_name_ids], extra)] for a in alns]

    monkeypatch.setattr(core.Serotyper, "map_batch", map_batch)


@pytest.mark.parametrize(
    "fault, count",
    [(_engine_left_out, "wrong_calls"), (_extra_hits_dropped, "missing_genes")],
    ids=["phenotype_engine_left_out", "extra_gene_hits_dropped"],
)
def test_every_phenotype_fault_makes_correct_false(tiny_root, monkeypatch, fault, count):
    fault(monkeypatch)
    # Long enough on the CPU for the window to reach the pool's first three entries.
    out = run_cell(tiny_root, "tiny_o.single", SEED, 12.0, False, "cpu", time.perf_counter())
    assert out.line["attempted"] >= 3, out.notes
    assert not out.line["correct"]
    assert out.checks[count][0] > 0, out.line["checks"]
