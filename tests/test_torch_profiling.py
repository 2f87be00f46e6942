"""The port's span recorder (``kaptive_tpu_torch.utils.profiling``): spans and their
parents, thread safety, request ids across the stream's threads, the disabled path,
``phase_report`` from the spans, the clock shared with ``torch.profiler``, and the
work counters of a typing run on the CPU, the phenotype stage's among them."""

import io
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from kaptive_tpu_torch.utils import profiling
from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot
from kaptive_tpu_torch.utils.profiling import phase_report, phase_timer, recording, request, reset_phases

torch.set_num_threads(1)


@pytest.fixture
def enabled(monkeypatch):
    monkeypatch.setenv("KAPTIVE_PROFILE", "1")
    reset_phases()
    yield
    reset_phases()


def test_spans_nest_and_name_their_parents(enabled):
    with request() as rid, phase_timer("outer") as outer:
        with phase_timer("inner") as inner:
            time.sleep(0.001)
        with phase_timer("second") as second:
            pass
    with phase_timer("alone") as alone:
        pass
    _, spans = recording()
    assert [s.name for s in spans] == ["inner", "second", "outer", "alone"]
    assert inner.parent is outer and second.parent is outer and outer.parent is None and alone.parent is None
    assert outer.start <= inner.start < inner.end <= second.start <= second.end <= outer.end
    assert inner.end - inner.start >= 1_000_000
    assert {s.thread for s in spans} == {threading.get_native_id()}
    assert rid is not None and {inner.request, second.request, outer.request} == {rid} and alone.request is None


def test_a_request_inside_a_request_keeps_the_outer_id(enabled):
    with request() as outer_id:
        with request() as inner_id, phase_timer("x") as x:
            pass
    assert inner_id is None and x.request == outer_id


def test_eight_threads_of_a_thousand_spans_give_exact_totals(enabled):
    n_threads, n_spans = 8, 1000
    errors = []

    def work(t: int) -> None:
        try:
            for i in range(n_spans):
                with phase_timer(f"t{t % 2}") as span:
                    span.add("test.work", 1)
                    with phase_timer("nested"):
                        pass
        except Exception as exc:  # noqa: BLE001 - reported by the main thread
            errors.append(exc)

    reset_metrics()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    _, spans = recording()
    assert len(spans) == 2 * n_threads * n_spans
    assert snapshot()["test.work"] == n_threads * n_spans
    assert sum(s.counts["test.work"] for s in spans if s.counts) == n_threads * n_spans
    for s in spans:
        if s.name == "nested":
            assert s.parent.name in ("t0", "t1") and s.parent.thread == s.thread
    with open("/dev/null", "w") as sink:
        report = phase_report(sink)
    assert report["nested"][0] == n_threads * n_spans
    assert report["t0"][0] == report["t1"][0] == n_threads * n_spans // 2


def test_phase_report_totals_are_the_sums_of_the_spans(enabled):
    for i in range(5):
        with phase_timer("a"):
            time.sleep(0.0005 * i)
        with phase_timer("b"):
            pass
    _, spans = recording()
    with open("/dev/null", "w") as sink:
        report = phase_report(sink)
    for name in ("a", "b"):
        mine = [s for s in spans if s.name == name]
        assert report[name][0] == len(mine) == 5
        assert report[name][1] == sum(s.end - s.start for s in mine) / 1e9
    assert report["a"][1] >= 0.005


def test_the_disabled_path_records_nothing_and_makes_no_object(monkeypatch):
    monkeypatch.delenv("KAPTIVE_PROFILE", raising=False)
    reset_phases()
    # One shared do-nothing context for every span and request: nothing is made per call.
    assert phase_timer("x") is phase_timer("y") is request() is profiling._OFF
    for _ in range(1000):
        with request(), phase_timer("x") as span:
            assert span is None
    assert recording()[1] == []
    assert profiling.clock_anchor() is None  # no profiler runs


def _trace(tmp_path, body):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reset_phases()  # anchors the recording to the running profiler
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_spans_land_on_the_profilers_clock(enabled, tmp_path):
    from torch.profiler import record_function

    def body():
        for i in range(5):
            with phase_timer(f"probe{i}"), record_function(f"probe{i}.block"):
                time.sleep(0.002)
            time.sleep(0.001)

    events = _trace(tmp_path, body)
    assert len([e for e in events if e.get("name") == profiling.CLOCK_MARK]) == profiling._ANCHOR_TRIES
    mapped = {e["name"]: e for e in profiling.trace_events(events)}
    blocks = {e["name"]: e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    for i in range(5):
        span, block = mapped[f"probe{i}"], blocks[f"probe{i}.block"]
        assert span["cat"] == "kaptive" and span["tid"] == threading.get_native_id()
        # The span holds the block, on one clock, to within 50 us at either end.
        assert span["ts"] - 50 <= block["ts"], (i, span, block)
        assert block["ts"] + block["dur"] <= span["ts"] + span["dur"] + 50, (i, span, block)
        assert span["dur"] >= 2000


def test_device_trace_writes_the_spans_of_every_thread(enabled, tmp_path):
    def other():
        with phase_timer("on.other.thread"):
            time.sleep(0.001)

    with profiling.device_trace(tmp_path) as path:
        with phase_timer("on.main.thread"):
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    events = json.loads(path.read_text())["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("cat") == "kaptive"}
    assert set(mine) == {"on.main.thread", "on.other.thread"}
    assert mine["on.main.thread"]["tid"] != mine["on.other.thread"]["tid"]
    main, other_span = mine["on.main.thread"], mine["on.other.thread"]
    assert main["ts"] <= other_span["ts"] and other_span["ts"] + other_span["dur"] <= main["ts"] + main["dur"]


@pytest.fixture(scope="module")
def port_panel(tmp_path_factory):
    from typing_panel import make_port_typing_panel

    tmp = tmp_path_factory.mktemp("profiling_panel")
    db, genomes = make_port_typing_panel(tmp)
    paths = []
    for name, fasta in genomes:
        path = tmp / f"{name}.fasta"
        path.write_bytes(fasta)
        paths.append(path)
    return db, paths


def test_stream_request_ids_reach_the_pool_map_and_consumer_threads(enabled, port_panel, monkeypatch):
    from kaptive_tpu_torch.parallel.pipeline import stream_type
    from kaptive_tpu_torch.serotyping import Serotyper

    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    db, paths = port_panel
    serotyper = Serotyper(db, device="cpu")
    reset_phases()
    got = list(stream_type(serotyper, list(paths), batch_size=2, max_workers=2))
    assert len(got) == len(paths)
    _, spans = recording()
    consumer = threading.get_native_id()
    by_request: dict = {}
    for s in spans:
        by_request.setdefault(s.request, []).append(s)
    assert None not in by_request  # every span of the stream serves a batch
    # Batches of 2 after a first of max(2 // 4, 1) = 1: 1 + 2 + 2.
    assert len(by_request) == 3
    for rid, mine in by_request.items():
        names = {s.name for s in mine}
        assert {"ingest.parse_pack", "map.seed", "map.chain", "stream.wait_ingest", "type.map",
                "map.problems", "map.extension_dp", "map.results", "stream.wait_map", "type.decide"} <= names, rid
        pool = {s.thread for s in mine if s.name == "ingest.parse_pack"}
        mapper = {s.thread for s in mine if s.name == "type.map"}
        finisher = {s.thread for s in mine if s.name == "type.decide"}
        assert finisher == {consumer} and len(mapper) == 1 and not (pool | mapper) & {consumer}
        assert mapper.isdisjoint(pool)


def test_work_counters_match_the_problems_of_a_typing_run(enabled, port_panel, monkeypatch):
    import kaptive_tpu_torch.core.pairwise as pairwise
    import kaptive_tpu_torch.ops.mapper as mapper
    from kaptive_tpu_torch.serotyping import Serotyper

    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    db, paths = port_panel
    serotyper = Serotyper(db, device="cpu")
    problems, cells = [], []
    launch_ext, align = mapper.launch_extension_dp_device, pairwise.batched_swg_align

    def launch_ext_seen(specs, *a, **kw):
        problems.append(len(specs["glen"]))
        cells.append(sum(int(q) * (2 * int(k) + 3) for q, k in zip(specs["glen"], specs["k_locals"])))
        return launch_ext(specs, *a, **kw)

    def align_seen(q_data, q_offsets, q_lengths, t_data, t_offsets, t_lengths, diag_offsets, k_locals, *a, **kw):
        cells.append(sum(int(q) * (2 * int(k) + 3) for q, k in zip(q_lengths, k_locals)))
        return align(q_data, q_offsets, q_lengths, t_data, t_offsets, t_lengths, diag_offsets, k_locals, *a, **kw)

    monkeypatch.setattr(mapper, "launch_extension_dp_device", launch_ext_seen)
    monkeypatch.setattr(pairwise, "batched_swg_align", align_seen)
    reset_phases()
    reset_metrics()
    results = serotyper.batch(list(paths))
    assert [r.best_locus_name for r in results] == ["KL1", "KL2", "KL3", "KL4", "KL1"]
    assert len(problems) == 1 and len(cells) == 2  # the extension sweep, then the protein sweep
    _, spans = recording()
    totals: dict = {}
    for s in spans:
        for name, n in (s.counts or {}).items():
            totals[name] = totals.get(name, 0) + n
    counters = snapshot()
    assert totals["map.chains"] == counters["map.chains"] == problems[0] > 0
    assert totals["dp.cells_live"] == counters["dp.cells_live"] == sum(cells)
    assert 0 < totals["dp.cells_live"] <= totals["dp.cells_launched"] == counters["dp.cells_launched"]
    assert {s.name for s in spans if "map.chains" in (s.counts or {})} == {"map.problems"}
    assert {s.name for s in spans if "dp.cells_live" in (s.counts or {})} == {"dp.launch"}
    [req] = [s for s in spans if s.name == "type.request"]
    assert all(s.request == req.request for s in spans)
    assert {"map.seed", "map.chain", "map.pack_upload", "map.problems", "map.extension_dp", "map.results",
            "dp.launch", "dp.collect", "type.states"} <= {s.name for s in spans}
    assert np.all([s.parent is not None for s in spans if s is not req])


def test_counters_are_left_alone_when_profiling_is_off(port_panel, monkeypatch):
    from kaptive_tpu_torch.serotyping import Serotyper

    monkeypatch.delenv("KAPTIVE_PROFILE", raising=False)
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    db, paths = port_panel
    reset_phases()
    reset_metrics()
    Serotyper(db, device="cpu").batch(list(paths[:1]))
    assert not {"map.chains", "dp.cells_live", "dp.cells_launched"} & set(snapshot())
    assert recording()[1] == []


@pytest.fixture(scope="module")
def o_panel(tmp_path_factory):
    from o_panel import CONFIG, make_o_panel

    from kaptive_tpu_torch.db import Database

    _, pool, gbk = make_o_panel(tmp_path_factory.mktemp("profiling_o_panel"))
    return Database.from_genbank(gbk), pool, CONFIG["phenotype_logic"]


def _rules_fired(db, result, rules) -> int:
    r"""The rules that fire for ``result``, worked out from its hits: the clusters of its NORMAL and
    PARTIAL hits are active, its best locus's own clusters the expected ones."""
    from fnmatch import fnmatchcase

    from kaptive_tpu_torch.serotyping.models import GeneState

    cluster = [db.cluster_keys[c] for c in db.gene_cluster_ids]
    intact = np.isin(result.gene_states, (GeneState.NORMAL.value, GeneState.PARTIAL.value))
    active = {cluster[g] for g in result.gene_hits.gene_indices[intact]}
    row = db.loci.ids.index(result.best_locus_name)
    expected = {cluster[g] for g in np.flatnonzero(db.gene_locus_indices == row)}
    fired = 0
    for rule in rules.values():
        inactive = {c for c in cluster if c in rule.get("inactive_genes", ())}
        fired += (any(fnmatchcase(result.best_locus_name, p) for p in rule["loci"])
                  and set(rule.get("extra_genes", ())) <= active
                  and (not inactive or bool((inactive & expected) - active)))
    return fired


def _phenotype_counts(db, fastas):
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.serotyping import Serotyper

    reset_phases()
    results = Serotyper(db, device="cpu").batch(
        [GenomeAssembly.from_stream(io.BytesIO(fasta), name) for name, fasta in fastas]
    )
    spans = [s for s in recording()[1] if s.name == "type.phenotype"]
    return results, spans


def test_the_phenotype_span_nests_in_finalize_and_counts_rules_and_extra_hits(enabled, o_panel, monkeypatch):
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    db, pool, rules = o_panel
    results, [span] = _phenotype_counts(db, [(a.name, a.fasta) for a in pool])
    assert span.parent is not None and span.parent.name == "type.finalize"
    assert span.parent.start <= span.start <= span.end <= span.parent.end
    fired = [_rules_fired(db, r, rules) for r in results]
    assert fired == [1, 1, 3, 1, 4, 0]  # o2 and o4 carry both extra genes; o4 is also knocked out
    assert span.counts["phenotype.fired"] == sum(fired)
    assert span.counts["decide.extra_hits"] == sum(int(r.gene_hits.is_extra.sum()) for r in results) > 0


def test_phenotype_counters_of_a_batch_are_the_sums_of_its_assemblies_alone(enabled, o_panel, monkeypatch):
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    db, pool, _ = o_panel
    pair = [(a.name, a.fasta) for a in (pool[2], pool[4])]
    _, [both] = _phenotype_counts(db, pair)
    alone = [_phenotype_counts(db, [one])[1][0] for one in pair]
    for counter in ("phenotype.fired", "decide.extra_hits"):
        assert both.counts[counter] == sum(s.counts[counter] for s in alone) > 0
