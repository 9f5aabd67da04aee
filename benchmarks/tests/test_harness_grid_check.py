"""The reader of the BEV loader's grid-order counters
(``grid_check_early_pct.bev``), on canned counter events that straddle the
traced window."""

from __future__ import annotations

import sys
import types
from types import SimpleNamespace

import pytest

from conftest import BENCH  # noqa: F401  (puts the harness on the path)

WINDOW = (1000.0, 2000.0)  # µs, the profiler's clock
CELL = "mulran-os1-64.bev"


def _read(monkeypatch, counts, items=64):
    """The reader, ``records()`` handing back ``counts`` (name, µs, n)."""
    from harness import cells
    from harness.trace import Trace

    from pctpu_torch.runtime import profiler

    events = [SimpleNamespace(name=n, t_ns=int(t_us * 1e3), n=k, thread=1, batch=None)
              for n, t_us, k in counts]
    monkeypatch.setattr(profiler, "records", lambda: ([], list(events)))
    return cells.metric_reader("grid_check_early_pct.bev")(
        Trace([], [], WINDOW, items, 2, {}), cells.resolve(CELL))


def test_early_share_of_the_window_s_checks(monkeypatch):
    counts = [("ordering.grid_check.early", 1100.0, 1), ("ordering.grid_check.early", 1500.0, 1),
              ("ordering.grid_check.early", 1900.0, 1), ("ordering.grid_check.full", 1800.0, 1),
              ("ordering.grid_check.full", 900.0, 5),     # before the window
              ("ordering.grid_check.early", 2100.0, 5),   # after it
              ("loader.other", 1500.0, 7)]
    assert _read(monkeypatch, counts) == pytest.approx(75.0)
    assert _read(monkeypatch, counts, items=0) is None
    assert _read(monkeypatch, [("ordering.grid_check.full", 900.0, 1)]) is None


def test_none_on_a_program_without_the_counters(monkeypatch):
    """The parent's program has the tracer but no such counter: None; a
    program without the tracer: None, and nothing raises."""
    assert _read(monkeypatch, [("loader.other", 1500.0, 1)]) is None
    from harness import cells
    from harness.trace import Trace

    monkeypatch.setitem(sys.modules, "pctpu_torch.runtime.profiler",
                        types.ModuleType("pctpu_torch.runtime.profiler"))
    assert cells.metric_reader("grid_check_early_pct.bev")(
        Trace([], [], WINDOW, 64, 2, {}), cells.resolve(CELL)) is None
    assert "grid_check_early_pct.bev" in {m["name"] for m in cells.resolve(CELL).per_layer}
