r"""The cells kpsc_o.single and kpsc_k.complete_batch64: found by name with the metrics they
report; the committed O configuration, cut to a short genome, reads correct on the CPU under its
mix's classes; the batch entry stamps every row of a batch when the batch's rows are out."""

from __future__ import annotations

import json
import os
import time

import pytest
from conftest import ENV, MIX, ROOT, make_tiny_root

from kbench import gen, harness
from kbench.harness import HarnessError, load_cell, run_cell
from reference.phenotype import expected_phenotypes

RULES = {"O1αβ,2α", "O2β", "O1αβ,2β", "O-antigen null"}
# A seed whose pool's first three entries are the three OL2α variants: one with wzm knocked out,
# one carrying the gml genes, one carrying wbbY and wbbZ.
O_SEED = 2**31 + 1923
SINGLE_METRICS = [
    "ingest.parse_index_ms.single", "map.map_ms.single", "dp.dp_ms.single", "decide.decide_ms.single",
    "device.idle_pct.single", "map.seed_ms.single", "map.chain_ms.single", "map.problems_ms.single",
    "map.results_ms.single", "dp.wait_ms.single", "report.row_ms.single", "map.chains.single",
    "dp.cells_live_pct.single", "dp.fill_gcups.single", "device.idle_unattributed_pct.single",
]


def test_both_new_cells_are_found_with_their_metrics():
    o = load_cell(ROOT, "kpsc_o.single")
    assert o.config["name"] == "kpsc_o" and len(o.config["loci"]) == 13 and o.traffic["entry"] == "single"
    assert set(o.config["phenotype_logic"]) == RULES
    assert all(len(rule.encode()) <= 32 for rule in o.config["phenotype_logic"])  # the program's S32 ids
    assert o.traffic["env"]["KAPTIVE_SEED_MODE"] == "auto"
    assert [m["name"] for m in o.end_to_end] == ["asm_per_s", "setup_s"]
    assert [m["name"] for m in o.per_layer] == SINGLE_METRICS + ["decide.phenotype_ms.single",
                                                                 "decide.extra_hits.single"]
    b = load_cell(ROOT, "kpsc_k.complete_batch64")
    assert b.config["name"] == "kpsc_k" and b.traffic["entry"] == "batch" and b.traffic["batch_size"] == 64
    assert b.traffic["env"]["KAPTIVE_SEED_MODE"] == "device"
    assert [m["name"] for m in b.end_to_end] == ["asm_per_s", "setup_s"]
    host_seed_only = {"map.seed_ms.single", "map.chain_ms.single"}
    assert [m["name"] for m in b.per_layer] == [m for m in SINGLE_METRICS if m not in host_seed_only]


def _o_root(tmp_path):
    r"""The committed kpsc_o configuration at a 40 kb genome under omix4_single's classes, every
    entry reached judged, as a cell of a tiny checkout."""
    root = make_tiny_root(tmp_path)
    cfg = json.loads((ROOT / "benchmark" / "configs" / "kpsc_o.json").read_text())
    cfg["genome_nt"] = 40000
    mix = json.loads((ROOT / "benchmark" / "traffic" / "omix4_single.json").read_text())
    mix.update(env=ENV, pool_size=32, check_sample=32)
    (root / "benchmark" / "configs" / "kpsc_o_cut.json").write_text(json.dumps(cfg, ensure_ascii=False))
    (root / "benchmark" / "traffic" / "omix4_cut.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "kpsc_o_cut", "source": "https://example.org/tiny", "why": "a CPU test",
                            "file": "benchmark/configs/kpsc_o_cut.json", "reduced": ["genome_nt"]})
    spec["workloads"].append({"name": "kpsc_o_cut.single", "config": "kpsc_o_cut", "traffic": "omix4_cut",
                              "chips": 1, "why": "a CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "kpsc_o.single" in m.get("workloads", ()):
            m["workloads"].append("kpsc_o_cut.single")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, cfg, mix


def test_the_o_configuration_cut_to_a_short_genome_is_correct(tmp_path):
    root, cfg, mix = _o_root(tmp_path)
    rng_db, rng_pool, _ = gen.seed_streams(O_SEED, 3)
    db = gen.make_database(cfg, rng_db)
    pool = gen.make_pool(mix, db, cfg["genome_nt"], rng_pool)
    want = expected_phenotypes(pool, db, cfg)
    assert [a.locus.name for a in pool[:3]] == ["OL2α.2", "OL2α.3", "OL2α.1"]
    assert want[:3] == ["O-antigen null", "O2β", "O1αβ,2α"] and pool[0].knocked
    # Long enough on the CPU for the window to reach the first three entries.
    out = run_cell(root, "kpsc_o_cut.single", O_SEED, 25.0, False, "cpu", time.perf_counter())
    assert out.line["attempted"] >= 3, out.notes
    assert out.line["correct"], out.notes
    assert all(v == 0 for v, _ in out.checks.values())
    judged = {asm.name: result for asm, result, *_ in out.checked}
    assert {"a000", "a001", "a002"} <= set(judged)
    assert [judged[f"a00{i}"].phenotype for i in range(3)] == want[:3]
    assert all(judged[f"a00{i}"].gene_hits.is_extra.sum() >= len(pool[i].extras) > 0 for i in (1, 2))


def _batch_root(tmp_path):
    root = make_tiny_root(tmp_path)
    mix = {"entry": "batch", "env": {"KAPTIVE_SEED_MODE": "device"}, "batch_size": 4, "pool_size": 8,
           "check_sample": 8, "classes": MIX}
    (root / "benchmark" / "traffic" / "tiny_batch4.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.batch4", "config": "tiny", "traffic": "tiny_batch4", "chips": 1,
                              "why": "a CPU test"})
    for m in spec["end_to_end"]:
        if m["name"] == "asm_per_s":
            m["workloads"].append("tiny.batch4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_the_batch_entry_stamps_each_batch_when_its_rows_are_out(tmp_path, monkeypatch):
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "auto")  # restored after the test
    root = _batch_root(tmp_path)
    seen = []
    real = harness.load_module

    def load_module(root_, kind, name):
        mod = real(root_, kind, name)
        if kind == "entries":
            window = mod.window

            def spy(d):
                window(d)
                seen.append((list(d.run.done_at), list(d.run.turnaround_s)))

            mod.window = spy
        return mod

    monkeypatch.setattr(harness, "load_module", load_module)
    out = run_cell(root, "tiny.batch4", 2**31 + 7, 15.0, False, "cpu", time.perf_counter())
    assert out.line["correct"], out.notes
    assert set(out.line["metrics"]) == {"asm_per_s", "setup_s"}
    [(done_at, turnaround)] = seen
    assert len(done_at) == out.line["attempted"] >= 4 and len(done_at) % 4 == 0
    for lo in range(0, len(done_at), 4):
        assert len(set(done_at[lo : lo + 4])) == 1 and len(set(turnaround[lo : lo + 4])) == 1
    assert done_at == sorted(done_at) and len(set(done_at)) == len(done_at) // 4
    assert {int(asm.name[1:]) // 4 for asm, *_ in out.checked} == {0, 1}  # rows of both batches judged
    assert os.environ["KAPTIVE_SEED_MODE"] == "device"


def test_a_batch_longer_than_half_the_window_gives_no_result(tmp_path, monkeypatch):
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "auto")  # restored after the test
    with pytest.raises(HarnessError, match="more than half"):
        run_cell(_batch_root(tmp_path), "tiny.batch4", 2**31 + 7, 0.01, False, "cpu", time.perf_counter())
