r"""The readers of the program's spans and counts, and the naming of a trace's idle time by program span."""

from __future__ import annotations

import time

import pytest

from conftest import ROOT

from kbench.harness import Run, load_reader, run_cell
from kbench.spans import collect_lag, idle_by_span
from kbench.trace import DeviceSummary

NEW = ("map.seed_ms.single", "map.chain_ms.single", "map.problems_ms.single", "map.results_ms.single",
       "dp.wait_ms.single", "report.row_ms.single", "map.chains.single", "dp.cells_live_pct.single",
       "dp.fill_gcups.single", "device.idle_unattributed_pct.single")


class _Span:
    def __init__(self, name, start, end, counts=None):
        self.name, self.start, self.end, self.counts = name, start, end, counts


def _read(name, run):
    return load_reader(ROOT, "layer_metrics", name)(run)


@pytest.fixture
def recorded(monkeypatch):
    r"""A stretch of two requests from t = 10 s (rows stamped at 9, 11.0 and 12.0 s), the program's
    recording fabricated: glue under type.request alone from 10.0 to 10.1 s and 11.0 to 11.2 s, and a
    third request after the stretch whose counts must not be read."""
    from kaptive_tpu_torch.utils import profiling

    s = 1_000_000_000
    spans = [
        _Span("type.request", 10 * s, 11 * s - s // 100),
        _Span("type.map", 10 * s + s // 10, 10 * s + 6 * s // 10),
        _Span("map.problems", 10 * s + 2 * s // 10, 10 * s + 3 * s // 10, {"map.chains": 1000}),
        _Span("dp.launch", 10 * s + 3 * s // 10, 10 * s + 4 * s // 10,
              {"dp.cells_live": 3 * 10**9, "dp.cells_launched": 4 * 10**9}),
        _Span("type.decide", 10 * s + 6 * s // 10, 11 * s - s // 100),
        _Span("report.row", 11 * s - s // 100, 11 * s - s // 200),
        _Span("type.request", 11 * s, 12 * s - s // 100),
        _Span("type.map", 11 * s + 2 * s // 10, 12 * s - s // 100),
        _Span("map.problems", 11 * s + 3 * s // 10, 11 * s + 4 * s // 10, {"map.chains": 1200}),
        _Span("dp.launch", 11 * s + 4 * s // 10, 11 * s + 5 * s // 10,
              {"dp.cells_live": 1 * 10**9, "dp.cells_launched": 4 * 10**9}),
        _Span("type.request", 12 * s + s // 100, 13 * s),
        _Span("map.problems", 12 * s + 3 * s // 10, 12 * s + 4 * s // 10, {"map.chains": 99999}),
    ]
    monkeypatch.setattr(profiling, "recording", lambda: (10 * s, spans), raising=False)
    device = DeviceSummary(window_s=2.0, busy_s=0.4, kernel_s=0.4,
                           device_ops=[("void (anonymous namespace)::swg_fill_warp_kernel<4, unsigned char>(int)", 0.3),
                                       ("void (anonymous namespace)::swg_fill_kernel<4, unsigned char>(int)", 0.1),
                                       ("Memcpy HtoD (Pageable -> Device)", 0.05)])
    return Run(seconds=8.0, setup_s=1.0, done_at=[9.0, 11.0, 12.0, 13.0], stretch_rows=2, device=device)


def test_the_counter_readers_read_the_stretchs_spans(recorded):
    assert _read("map.chains.single", recorded) == pytest.approx(1100.0)
    assert _read("dp.cells_live_pct.single", recorded) == pytest.approx(50.0)
    assert _read("dp.fill_gcups.single", recorded) == pytest.approx(4e9 / 0.4 / 1e9)
    # The stretch, 10-12 s, less what spans other than type.request cover, 10.1-10.995 s (to the end of
    # the row's span) and 11.2-11.99 s: 0.315 s, of 1.6 s idle.
    assert _read("device.idle_unattributed_pct.single", recorded) == pytest.approx(100 * 0.315 / 1.6)


def test_the_span_readers_read_the_phases():
    run = Run(seconds=8.0, setup_s=1.0, stretch_rows=4,
              phases={"map.seed": 0.2, "map.chain": 0.1, "map.problems": 0.08, "map.results": 0.04,
                      "dp.collect": 0.02, "report.row": 0.004, "type.map": 1.0})
    want = {"map.seed_ms.single": 50.0, "map.chain_ms.single": 25.0, "map.problems_ms.single": 20.0,
            "map.results_ms.single": 10.0, "dp.wait_ms.single": 5.0, "report.row_ms.single": 1.0}
    for name, value in want.items():
        assert _read(name, run) == pytest.approx(value), name


def test_a_program_without_the_spans_gives_nothing(monkeypatch):
    from kaptive_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    run = Run(seconds=8.0, setup_s=1.0, done_at=[1.0, 2.0], stretch_rows=2,
              phases={"type.map": 1.0, "map.host_seed": 0.5, "map.chain_host": 0.1},
              device=DeviceSummary(window_s=2.0, busy_s=0.4, kernel_s=0.4, device_ops=[("swg_fill_kernel", 0.1)]))
    for name in NEW:
        assert _read(name, run) is None, name


def _x(name, ts, dur, cat="kernel", tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_idle_gaps_are_split_and_named_by_the_innermost_span():
    events = [_x("k1", 0, 10), _x("k2", 50, 10), _x("k3", 90, 10)]
    spans = [(0, 100, "type.request"), (5, 45, "type.map"), (20, 30, "map.seed"), (60, 70, "type.decide")]
    got = idle_by_span(events, spans, 0, 120, fallback=[(0, 120, "request")])
    # Gap 10-50: type.map 10-20, map.seed 20-30, type.map 30-45, type.request 45-50; gap 60-90:
    # type.decide 60-70, type.request 70-90; gap 100-120: no program span, named by the harness's.
    assert got["pieces"] == [("type.request", 20e-6), ("request", 20e-6), ("type.map", 15e-6),
                             ("type.map", 10e-6), ("map.seed", 10e-6), ("type.decide", 10e-6),
                             ("type.request", 5e-6)]
    assert got["idle_s"] == pytest.approx(90e-6)
    assert got["unattributed_s"] == pytest.approx(45e-6)  # 45-50, 70-90, 100-120
    assert got["by_name"]["type.map"] == pytest.approx(25e-6)


def test_collect_lag_measures_from_the_last_kernel_of_its_sweep():
    events = [_x("fill", 12, 30), _x("traceback", 44, 4), _x("next", 80, 5)]
    spans = [(10, 20, "dp.launch", 7), (20, 50, "dp.collect", 7), (70, 75, "dp.launch", 7), (75, 78, "dp.collect", 7)]
    assert collect_lag(events, spans) == [2.0]  # the second sweep launched nothing before its collect ended


def test_a_traced_run_reports_the_new_metrics(tiny_root):
    out = run_cell(tiny_root, "tiny.single", 2**31 + 33, 16.0, True, "cpu", time.perf_counter())
    assert out.line["correct"], out.notes
    metrics = out.line["metrics"]
    for name in ("map.seed_ms.single", "map.chain_ms.single", "map.problems_ms.single", "map.results_ms.single",
                 "dp.wait_ms.single", "report.row_ms.single", "map.chains.single", "dp.cells_live_pct.single"):
        assert metrics[name]["value"] > 0, name
    assert 0 < metrics["dp.cells_live_pct.single"]["value"] <= 100
    # Nothing ran on a device: the readers of device time find nothing.
    assert "dp.fill_gcups.single" not in metrics and "device.idle_unattributed_pct.single" not in metrics
    assert metrics["map.seed_ms.single"]["value"] < metrics["map.map_ms.single"]["value"]
