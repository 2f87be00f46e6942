r"""The harness is driven by files: a cell, a configuration, a mix, an entry and a metric are found
by name, and BENCHMARK.json keeps to the limits of its format."""

from __future__ import annotations

import json
import os
import re
import time

from conftest import MIX, ROOT, make_tiny_root

from kbench.harness import Run, load_cell, load_reader, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_a_cell_added_as_files_is_found(tiny_root):
    cell = load_cell(tiny_root, "tiny.single")
    assert cell.config["n_loci"] == 6 and cell.traffic["entry"] == "single"
    assert cell.traffic["env"] == {"KAPTIVE_SEED_MODE": "auto"}
    assert [m["name"] for m in cell.end_to_end] == ["asm_per_s", "asm_p95_ms", "setup_s"]
    assert "map.map_ms.single" in [m["name"] for m in cell.per_layer]
    stream = load_cell(tiny_root, "tiny.stream")
    assert [m["name"] for m in stream.end_to_end] == ["asm_per_s", "setup_s"]


def test_a_metric_added_as_a_file_is_read(tiny_root):
    (tiny_root / "benchmark" / "layer_metrics" / "report.rows_seen.batch.py").write_text(
        "def read(run):\n    return float(len(run.done_at)) or None\n"
    )
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "report.rows_seen.batch", "unit": "rows", "better": "higher",
                              "source": "program_counter", "layer": "report", "moves": "asm_per_s",
                              "workloads": ["tiny.stream"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell(tiny_root, "tiny.stream")
    assert "report.rows_seen.batch" in [m["name"] for m in cell.per_layer]
    read = load_reader(tiny_root, "layer_metrics", "report.rows_seen.batch")
    assert read(Run(seconds=1.0, setup_s=0.0, done_at=[0.1, 0.2])) == 2.0
    assert read(Run(seconds=1.0, setup_s=0.0)) is None


PAIRS_ENTRY = '''
from kbench.harness import handle, row_bytes


def warm(d):
    d.serotyper.batch([handle(a) for a in d.pool[:2]])


def window(d):
    run, n, k = d.run, len(d.pool), 0
    run.window_start = d.clock()
    while d.clock() < run.window_start + run.seconds:
        idx = [k % n, (k + 1) % n]
        t_in = d.clock()
        results = d.serotyper.batch([handle(d.pool[i]) for i in idx])
        rows = [row_bytes(r) for r in results]
        t_out = d.clock()
        for i, r, row in zip(idx, results, rows):
            run.done_at.append(t_out)
            run.turnaround_s.append(t_out - t_in)
            d.observer.see(i, r, row)
        k += 2
    d.stretch.finish(len(run.done_at))
'''


def test_an_entry_added_as_a_file_drives_a_new_cell(tmp_path, monkeypatch):
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "auto")  # restored after the test
    root = make_tiny_root(tmp_path)
    (root / "benchmark" / "entries" / "pairs.py").write_text(PAIRS_ENTRY)
    mix = {"entry": "pairs", "env": {"KAPTIVE_SEED_MODE": "host"}, "pool_size": 4, "check_sample": 2, "classes": MIX}
    (root / "benchmark" / "traffic" / "tiny_pairs.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.pairs", "config": "tiny", "traffic": "tiny_pairs", "chips": 1,
                              "why": "two assemblies a request"})
    for m in spec["end_to_end"]:
        if m["name"] == "asm_per_s":
            m["workloads"].append("tiny.pairs")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_cell(root, "tiny.pairs", 2**31 + 5, 12.0, False, "cpu", time.perf_counter())
    assert out.line["correct"], out.notes
    assert out.line["attempted"] >= 2 and out.line["attempted"] % 2 == 0
    assert set(out.line["metrics"]) == {"asm_per_s", "setup_s"}
    # A pair of tiny requests can outlast the window on a CPU loaded by parallel tests: the rate is
    # reported, and positive where a pair ends inside the window.
    assert out.line["metrics"]["asm_per_s"]["value"] >= 0 and out.line["metrics"]["asm_per_s"]["unit"] == "asm/s"
    assert os.environ["KAPTIVE_SEED_MODE"] == "host"  # the mix's environment, set from its data


def test_benchmark_json_keeps_to_its_format():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and len(w["why"]) <= 200
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "entries" / f"{traffic['entry']}.py").is_file()
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in {(x["config"], x["traffic"]) for x in spec["workloads"] if x is not w}
    assert used == configs
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "benchmark" / "end_to_end" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert all(c in e2e[m["moves"]].get("workloads", cells) for c in m["workloads"])
        assert (ROOT / "benchmark" / "layer_metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = [m for m in spec["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(cell in m["workloads"] for m in spec["per_layer"])
