"""The readers of the program's own spans and counters
(``pctpu_torch.runtime.profiler.records``), on canned events that straddle
the traced window."""

from __future__ import annotations

import sys
import types
from types import SimpleNamespace

import pytest

from conftest import BENCH  # noqa: F401  (puts the harness on the path)

WINDOW = (1000.0, 2000.0)  # µs, the profiler's clock
MAIN, WORKER = 11, 22


def _trace(items=10):
    from harness.trace import Trace

    return Trace([], [], WINDOW, items, 2, {})


def _span(name, a_us, b_us, thread=MAIN, parent=None, id=None):
    return SimpleNamespace(name=name, start_ns=int(a_us * 1e3), end_ns=int(b_us * 1e3),
                           thread=thread, parent=parent, batch=None, id=id)


def _count(name, t_us, n):
    return SimpleNamespace(name=name, t_ns=int(t_us * 1e3), n=n, thread=MAIN, batch=None)


def _read(name, cell="kitti-hdl64e.toppart64", items=10):
    from harness import cells

    return cells.metric_reader(name)(_trace(items), cells.resolve(cell))


@pytest.fixture
def canned(monkeypatch):
    """``records()`` handing back the given spans and counter events."""
    from pctpu_torch.runtime import profiler

    def give(spans=(), counts=()):
        monkeypatch.setattr(profiler, "records", lambda: (list(spans), list(counts)))
    return give


@pytest.mark.parametrize("metric,span,cell", [
    ("upload_ms_per_pair.reg", "cloud.upload", "kitti-hdl64e.toppart64"),
    ("icp_wait_ms_per_pair.reg", "icp.wait", "kitti-hdl64e.whole64"),
    ("pin_ms_per_cloud.bev", "multi_bev.pin", "mulran-os1-64.bev"),
    ("loader_wait_ms_per_cloud.bev", "loader.wait", "mulran-os1-64.bev"),
])
def test_span_time_is_clipped_to_the_window(canned, metric, span, cell):
    canned([
        _span(span, 900.0, 1100.0),                 # 100 µs inside
        _span(span, 1200.0, 1500.0, thread=WORKER),  # 300 µs, another thread
        _span(span, 1900.0, 2400.0),                # 100 µs inside
        _span(span, 2100.0, 2300.0),                # after the window
        _span(span, 100.0, 900.0),                  # before it
        _span("other", 1000.0, 2000.0),
    ])
    assert _read(metric, cell) == pytest.approx(0.5 / 10)
    assert _read(metric, cell, items=0) is None
    canned([_span(span, 100.0, 900.0), _span("other", 1000.0, 2000.0)])
    assert _read(metric, cell) is None


def test_icp_issue_is_the_loops_self_time(canned):
    canned([
        # a loop straddling the window's start: 500 µs inside, of which its
        # waits cover 100 (one clipped to 50) and a child on another
        # thread covers nothing
        _span("icp.loop", 500.0, 1500.0, id=1),
        _span("icp.wait", 950.0, 1050.0, parent=1),
        _span("icp.wait", 1300.0, 1350.0, parent=1),
        _span("cloud.upload", 1100.0, 1400.0, thread=WORKER, parent=1),
        # a grandchild is its child's, not the loop's
        _span("registration.x", 1400.0, 1450.0, parent=1, id=2),
        _span("icp.wait", 1410.0, 1440.0, parent=2),
        # a loop inside: 200 µs, a wait of 40
        _span("icp.loop", 1600.0, 1800.0, thread=WORKER, id=3),
        _span("icp.wait", 1700.0, 1740.0, thread=WORKER, parent=3),
        # outside the window
        _span("icp.loop", 2100.0, 2200.0, id=4),
    ])
    own = (500.0 - 50.0 - 50.0 - 50.0) + (200.0 - 40.0)
    assert _read("icp_issue_ms_per_pair.reg") == pytest.approx(own / 1e3 / 10)
    assert _read("icp_issue_ms_per_pair.reg", "kitti-hdl64e.whole64",
                 items=20) == pytest.approx(own / 1e3 / 20)
    canned([_span("icp.wait", 1100.0, 1200.0)])
    assert _read("icp_issue_ms_per_pair.reg") is None


def test_counter_shares_take_the_window_s_events(canned):
    canned(counts=[
        _count("icp.problem_iterations", 1100.0, 30),
        _count("icp.problem_slots", 1100.0, 40),
        _count("icp.problem_iterations", 1500.0, 15),
        _count("icp.problem_slots", 1500.0, 20),
        _count("icp.problem_slots", 2500.0, 1000),     # after the window
        _count("registration.bucket_hit.coarse", 1200.0, 1),
        _count("registration.bucket_hit.fine", 1200.0, 1),
        _count("registration.bucket_hit.coarse", 1800.0, 1),
        _count("registration.bucket_miss.fine", 1800.0, 1),
        _count("registration.bucket_miss.coarse", 900.0, 5),  # before it
    ])
    assert _read("icp_useful_pct.reg") == pytest.approx(100.0 * 45 / 60)
    assert _read("bucket_miss_pct.reg") == pytest.approx(25.0)
    canned(counts=[_count("icp.problem_slots", 2500.0, 10),
                   _count("registration.bucket_hit.coarse", 2500.0, 1)])
    assert _read("icp_useful_pct.reg") is None
    assert _read("bucket_miss_pct.reg") is None


NEW = ["upload_ms_per_pair.reg", "icp_issue_ms_per_pair.reg", "icp_wait_ms_per_pair.reg",
       "icp_useful_pct.reg", "bucket_miss_pct.reg", "pin_ms_per_cloud.bev",
       "loader_wait_ms_per_cloud.bev"]


@pytest.mark.parametrize("metric", NEW)
def test_none_without_the_tracer(canned, monkeypatch, metric):
    """A program without ``profiler.records`` (a parent commit) reads None,
    and does not raise."""
    canned([_span(n, 1100.0, 1200.0, id=1) for n in
            ("cloud.upload", "icp.loop", "icp.wait", "multi_bev.pin", "loader.wait")],
           [_count(n, 1100.0, 1) for n in ("icp.problem_iterations", "icp.problem_slots",
                                           "registration.bucket_miss.fine")])
    cell = "mulran-os1-64.bev" if metric.endswith(".bev") else "kitti-hdl64e.toppart64"
    assert _read(metric, cell) is not None
    monkeypatch.setitem(sys.modules, "pctpu_torch.runtime.profiler",
                        types.ModuleType("pctpu_torch.runtime.profiler"))
    assert _read(metric, cell) is None


def test_every_new_metric_is_reported_by_its_cells():
    from harness import cells

    want = {"kitti-hdl64e.toppart64": NEW[:5], "kitti-hdl64e.whole64": NEW[:4],
            "mulran-os1-64.bev": NEW[5:]}
    for cell, names in want.items():
        entries = {m["name"]: m for m in cells.resolve(cell).per_layer}
        assert set(names) <= set(entries)
        assert {entries[n]["source"] for n in names} <= {"program_span", "program_counter"}


def _device(a_us, b_us):
    from harness.trace import DeviceEvent

    return DeviceEvent("k", a_us, b_us)


def test_idle_goes_to_the_innermost_working_span():
    """``idle_by_span.py``'s attribution: a gap to the latest-started
    working span open at its middle on any thread, to a ``.wait`` span only
    where no working span is open, else to no span."""
    from harness.trace import Trace
    from idle_by_span import NO_SPAN, idle_by_span

    # busy 1100-1200, 1400-1500, 1700-1800: gaps 1000-1100, 1200-1400,
    # 1500-1700, 1800-2000 (middles 1050, 1300, 1600, 1900)
    trace = Trace([_device(1100.0, 1200.0), _device(1400.0, 1500.0), _device(1700.0, 1800.0)],
                  [], WINDOW, 10, 2, {})
    spans = [
        _span("registration.load", 900.0, 1450.0, thread=WORKER),
        _span("cloud.upload", 1250.0, 1350.0, thread=WORKER),     # inner: takes 1300
        _span("registration.worker.wait", 1000.0, 1650.0),        # a wait: loses to work
        _span("icp.wait", 1550.0, 1650.0),                        # alone at 1600
        _span("icp.loop", 1010.0, 1100.0),                        # later start: takes 1050
    ]
    got = idle_by_span(trace, spans)
    assert got == pytest.approx({"icp.loop": 100e-6, "cloud.upload": 200e-6,
                                 "icp.wait": 200e-6, NO_SPAN: 200e-6})
    assert sum(got.values()) == pytest.approx(0.7e-3)


def test_events_a_batch_take_the_window_s_events():
    from idle_by_span import events_per_batch

    spans = [_span("a", 1100.0, 1200.0), _span("a", 900.0, 1200.0), _span("b", 1500.0, 2500.0)]
    counts = [_count("c", 1999.0, 7), _count("c", 2001.0, 1)]
    got = events_per_batch(_trace(), spans, counts)
    assert got == {"all": 1.5, "by_name": {"a": 0.5, "b": 0.5, "c": 0.5}}


def test_idle_by_span_runs_a_registration_cell(monkeypatch, tmp_path):
    """The tool end to end on the CPU at small traffic: the drivers' spans
    of both threads are recorded and own the window's idle time, and its
    Chrome trace holds them with their batch indices."""
    import argparse
    import itertools
    import json

    import torch
    from conftest import SMALL, THIN
    from harness import cells, main, reg_window, scene

    import idle_by_span

    keyframe = scene.keyframe
    monkeypatch.setattr(scene, "keyframe",
                        lambda *a, **k: {f: v[::THIN] for f, v in keyframe(*a, **k).items()})
    orig = cells.resolve

    def resolve(name, root=cells.ROOT):
        c = orig(name, root)
        c.traffic.update(SMALL[c.traffic["window"]])
        return c

    monkeypatch.setattr(main, "resolve", resolve)
    monkeypatch.setattr(idle_by_span, "span_cost_us", lambda: {})
    # the window's clock ticks a second a read: exactly two batches, however
    # slow the host, so batch k+2 is loaded, run and fetched inside it
    ticks = itertools.count()
    monkeypatch.setattr(reg_window, "time", SimpleNamespace(perf_counter=lambda: float(next(ticks))))
    chrome = tmp_path / "window.json"
    args = argparse.Namespace(workload="kitti-hdl64e.toppart64", seed=2**31 + 11, seconds=1.5,
                              chrome=str(chrome))
    out = idle_by_span.run(args, device=torch.device("cpu"))
    assert out["batches"] == 2 and out["idle_s"] == pytest.approx(out["window_s"], rel=1e-6)
    assert 0.0 <= out["in_span_share"] <= 1.0
    names = out["events_per_batch"]["by_name"]
    for name in ("registration.load", "registration.coarse", "registration.worker.wait",
                 "cloud.upload", "icp.loop", "icp.iterations"):
        assert names.get(name, 0) > 0, name
    assert {k for k, _ in out["idle_by_span"]} <= set(names) | {idle_by_span.NO_SPAN}
    # every span the block recorded, of both threads, with parents and batches
    events = [e for e in json.loads(chrome.read_text())["traceEvents"]
              if e.get("cat") == "pctpu_torch"]
    recorded = {e["name"] for e in events}
    assert {"registration.load", "registration.coarse", "registration.fine",
            "registration.worker.wait", "cloud.upload", "icp.loop"} <= recorded
    (main_tid,) = {e["tid"] for e in events if e["name"] == "registration.worker.wait"}
    waited = {e["args"]["batch"] for e in events if e["name"] == "registration.worker.wait"}
    worked = {e["args"]["batch"] for e in events if e["tid"] != main_tid and e["ph"] == "X"}
    assert None not in waited and waited & worked
