"""The reader of the cloud upload's counters (``upload_staged_pct.reg``), on
canned counter events that straddle the traced window."""

from __future__ import annotations

import sys
import types
from types import SimpleNamespace

import pytest

from conftest import BENCH  # noqa: F401  (puts the harness on the path)

WINDOW = (1000.0, 2000.0)  # µs, the profiler's clock
CELLS = ("kitti-hdl64e.toppart64", "kitti-hdl64e.whole64")


def _read(monkeypatch, counts, items=64, cell=CELLS[0]):
    """The reader, ``records()`` handing back ``counts`` (name, µs, n)."""
    from harness import cells
    from harness.trace import Trace

    from pctpu_torch.runtime import profiler

    events = [SimpleNamespace(name=n, t_ns=int(t_us * 1e3), n=k, thread=1, batch=None)
              for n, t_us, k in counts]
    monkeypatch.setattr(profiler, "records", lambda: ([], list(events)))
    return cells.metric_reader("upload_staged_pct.reg")(
        Trace([], [], WINDOW, items, 2, {}), cells.resolve(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_staged_share_of_the_window_s_uploads(monkeypatch, cell):
    counts = [("cloud.upload.staged", 1000.0, 1), ("cloud.upload.staged", 1500.0, 2),
              ("cloud.upload.direct", 2000.0, 1),
              ("cloud.upload.direct", 999.0, 9),     # before the window
              ("cloud.upload.staged", 2001.0, 9),    # after it
              ("registration.bucket_hit.fine", 1500.0, 7)]
    assert _read(monkeypatch, counts, cell=cell) == pytest.approx(75.0)
    assert _read(monkeypatch, counts[:2], cell=cell) == pytest.approx(100.0)
    assert _read(monkeypatch, counts, items=0, cell=cell) is None
    assert _read(monkeypatch, [("cloud.upload.direct", 900.0, 1)], cell=cell) is None
    from harness import cells

    assert "upload_staged_pct.reg" in {m["name"] for m in cells.resolve(cell).per_layer}


def test_none_on_a_program_without_the_counters(monkeypatch):
    """The parent's program has the tracer but no such counter: None; a
    program without the tracer: None, and nothing raises."""
    assert _read(monkeypatch, [("icp.iterations", 1500.0, 1)]) is None
    from harness import cells
    from harness.trace import Trace

    monkeypatch.setitem(sys.modules, "pctpu_torch.runtime.profiler",
                        types.ModuleType("pctpu_torch.runtime.profiler"))
    assert cells.metric_reader("upload_staged_pct.reg")(
        Trace([], [], WINDOW, 64, 2, {}), cells.resolve(CELLS[0])) is None
    assert "upload_staged_pct.reg" not in {
        m["name"] for m in cells.resolve("mulran-os1-64.bev").per_layer}
