"""The Oxford cell: the frozen selector layout, the window's pool, the cell's
names, the new counter reader, and runs on the CPU at small traffic, sound
and broken.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import BENCH, ROOT, small_run

CELL = "oxford-hdl32e.bev"
SMALL = {"batch": 2, "pool": 2, "warmup_batches": 1, "check_batches": 1}
CONFIG_ENTRY = {
    "name": "oxford-hdl32e",
    "source": "Oxford Radar RobotCar (Barnes et al. ICRA 2020) Velodyne HDL-32E velodyne_left; "
              "data prep per soytony/Point-Cloud-Preprocessing-Tools README: "
              "OxfordPointCloudSelect, BatchMultiBevGen HDL_32E",
    "file": "benchmarks/configs/oxford-hdl32e.json", "reduced": ["keyframes"],
    "why": "HDL-32E returns in firing order, 1,085 firings into 1,056 columns: the ordering's "
           "last-wins rule decides slots, on a 32-row grid with 20 ground rows"}
WORKLOAD_ENTRY = {
    "name": CELL, "config": "oxford-hdl32e", "traffic": "bev_oxford", "chips": 1,
    "why": "batch_multi_bev_gen's loop body on Oxford HDL-32E keyframes in batches of 32: firing "
           "order, about 2.5% of returns lose their slot to a later one, so last-wins decides; "
           "32-row ground sums, 0.5 m layers"}
METRIC_ENTRY = {
    "name": "slots_lost_pct.bev", "unit": "%", "better": "lower", "source": "program_counter",
    "layer": "device preprocess (ops/preprocess.py, ordering, ground, bev)",
    "moves": "clouds_per_s", "workloads": [CELL]}
# the .bev metrics whose readers take the grid and the batch from the cell;
# grid_check_early_pct.bev has nothing to read here (no Oxford cloud fills
# the grid, so the check returns before it counts)
BEV_METRICS = ("clouds_per_s", "copy_ms_per_cloud.bev", "kernels_per_cloud.bev",
               "raster_roofline_pct.bev", "device_busy_ms_per_cloud.bev", "device_idle_pct.bev",
               "pin_ms_per_cloud.bev", "loader_wait_ms_per_cloud.bev")


def test_entries_keep_the_benchmarks_limits():
    """``BENCHMARK.json`` holds the cell's entries, last in their lists and
    within the limits of its form; the cell is added to the lists of
    ``clouds_per_s`` and the ``.bev`` metrics that read it."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert bench["configs"][-1] == CONFIG_ENTRY
    assert bench["workloads"][-1] == WORKLOAD_ENTRY
    assert bench["per_layer"][-1] == METRIC_ENTRY
    for entry in (CONFIG_ENTRY, WORKLOAD_ENTRY):
        assert 1 <= len(entry["why"]) <= 200
    assert len(CONFIG_ENTRY["source"]) <= 200
    assert os.path.isfile(os.path.join(ROOT, CONFIG_ENTRY["file"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (CELL in m.get("workloads", [])) == (m["name"] in BEV_METRICS + ("slots_lost_pct.bev",))


def _config() -> dict:
    return json.load(open(os.path.join(BENCH, "configs", "oxford-hdl32e.json")))


def _sweep(seed: int):
    from harness import oxford_scene, scene

    rng = np.random.default_rng(seed)
    boxes = scene.world(rng, 10.0)
    return scene._scan(boxes, np.array([0.0, 2.5]), 0.3, oxford_scene.hdl32e_elevations(),
                       oxford_scene.FIRINGS, rng)


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_layout_equals_the_programs_reader(tmp_path, seed):
    """The frozen selector rule and ``pctpu_torch.io.oxford.read_bin`` give
    the same keyframe, field by field and bit by bit, from the same .bin
    bytes."""
    from harness import oxford_scene
    from pctpu_torch.io.oxford import read_bin

    raw = oxford_scene.oxford_bin(*_sweep(seed))
    path = tmp_path / "0000000001.bin"
    raw.tofile(path)
    want = read_bin(str(path))
    got = oxford_scene.oxford_points(np.fromfile(path, np.float32))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_bin_holds_returns_in_firing_order_upside_down():
    """Returns only, firing by firing, 32 rings a firing, x and z negated,
    stored columnwise; two firings share a column 29 times a ring."""
    from harness import oxford_scene

    pts, hit, inten = _sweep(7)
    raw = oxford_scene.oxford_bin(pts, hit, inten)
    n = int(hit.sum())
    assert raw.dtype == np.float32 and raw.shape == (4 * n,)
    first = np.flatnonzero(hit[:, 0])
    np.testing.assert_array_equal(raw[:len(first)], -pts[first, 0, 0])
    np.testing.assert_array_equal(raw[n:n + len(first)], pts[first, 0, 1])
    np.testing.assert_array_equal(raw[2 * n:2 * n + len(first)], -pts[first, 0, 2])
    np.testing.assert_array_equal(raw[3 * n:3 * n + len(first)], inten[first, 0])
    kf = oxford_scene.oxford_points(raw)
    cols = np.round(np.arange(oxford_scene.FIRINGS) * oxford_scene.HORIZON_SCAN
                    / oxford_scene.FIRINGS) % oxford_scene.HORIZON_SCAN
    assert oxford_scene.FIRINGS - len(np.unique(cols)) == 29
    ring = kf["row"].astype(np.int64)
    assert set(np.unique(ring)) <= set(range(32)) and len(np.unique(ring)) > 20


def test_cell_resolves():
    from harness import cells, checks

    cell = cells.resolve(CELL)
    assert cell.config["name"] == "oxford-hdl32e" and cell.chips == 1
    assert cell.config["layout"] == "oxford_select"
    assert cell.config["sensor"] == {"n_scan": 32, "horizon_scan": 1056,
                                     "ground_upper_scan": 20, "height_res": 0.5}
    assert cell.traffic["window"] == "harness.oxford_bev_window"
    assert cell.traffic["control"] == "bf16_wire"
    assert {k: cell.traffic[k] for k in ("batch", "pool", "warmup_batches", "check_batches")} \
        == {"batch": 32, "pool": 8, "warmup_batches": 3, "check_batches": 2}
    assert checks.rules(CELL) == {"limits": {"clouds_off": 0}}
    assert {m["name"] for m in cell.end_to_end} == {"clouds_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert "slots_lost_pct.bev" in names and "raster_roofline_pct.bev" in names
    assert "grid_check_early_pct.bev" not in names  # no Oxford cloud fills the grid
    for ref in cell.config["reference"]:
        assert os.path.isfile(os.path.join(ROOT, ref))
    assert callable(cells.metric_reader("slots_lost_pct.bev"))


def test_pool_shape_and_refusal(monkeypatch):
    """The pool is ``pool`` keyframes in the loader's arrays at the 33,792
    slots, none grid-ordered, each with about 2.5% of its returns sharing
    a slot with a later one; a keyframe over the grid is refused."""
    from harness import oxford_bev_window, oxford_scene
    from pctpu_torch.config import SensorParams
    from pctpu_torch.ops.ordering import arrays_grid_ordered

    cfg = _config()
    params = SensorParams(**cfg["sensor"])
    pool = oxford_bev_window.make_pool(cfg, {"pool": 2}, 2**31 + 9)
    assert len(pool) == 2
    for a in pool:
        assert a["xyz"].shape == (33_792, 3) and a["row"].dtype == np.uint16
        n = int(a["count"])
        assert 25_000 < n < 33_792
        assert not arrays_grid_ordered(a, params)
        slots = a["row"][:n].astype(np.int64) * 1056 + a["col"][:n]
        assert 2.0 < 100.0 * (n - len(np.unique(slots))) / n < 4.0
    again = oxford_bev_window.make_pool(cfg, {"pool": 2}, 2**31 + 9)
    assert all(x["xyz"].tobytes() == y["xyz"].tobytes() for x, y in zip(pool, again))
    with pytest.raises(ValueError):
        oxford_bev_window.make_pool({**cfg, "keyframes": 1}, {"pool": 2}, 7)
    keyframe = oxford_scene.keyframe

    def over(*a, **k):
        kf = keyframe(*a, **k)
        return {f: np.concatenate([v, v]) for f, v in kf.items()}

    monkeypatch.setattr(oxford_scene, "keyframe", over)
    with pytest.raises(ValueError, match="more than the 33792 slots"):
        oxford_bev_window.make_pool(cfg, {"pool": 1}, 7)


def _count(name, t_us, n):
    return SimpleNamespace(name=name, t_ns=int(t_us * 1e3), n=n, thread=1, batch=None)


def test_slots_lost_reader(monkeypatch):
    """``slots_lost_pct.bev`` is the window's ``ordering.slots_lost`` over
    its ``ordering.points``; None without items, events or the tracer."""
    import types

    from harness import cells
    from harness.trace import Trace
    from pctpu_torch.runtime import profiler

    read = cells.metric_reader("slots_lost_pct.bev")
    cell = cells.resolve(CELL)
    counts = [_count("ordering.points", 1100.0, 30_000), _count("ordering.slots_lost", 1100.0, 750),
              _count("ordering.points", 1900.0, 10_000), _count("ordering.slots_lost", 1900.0, 250),
              _count("ordering.points", 900.0, 5_000),        # before the window
              _count("ordering.slots_lost", 2100.0, 4_000),   # after it
              _count("ordering.grid_check.full", 1500.0, 1)]
    monkeypatch.setattr(profiler, "records", lambda: ([], list(counts)))
    trace = Trace([], [], (1000.0, 2000.0), 64, 2, {})
    assert read(trace, cell) == pytest.approx(2.5)
    assert read(Trace([], [], (1000.0, 2000.0), 0, 0, {}), cell) is None
    monkeypatch.setattr(profiler, "records", lambda: ([], counts[4:]))
    assert read(trace, cell) is None
    monkeypatch.setitem(sys.modules, "pctpu_torch.runtime.profiler",
                        types.ModuleType("pctpu_torch.runtime.profiler"))
    assert read(trace, cell) is None


def test_sound_run_is_correct(monkeypatch):
    code, result = small_run(CELL, monkeypatch, traffic=SMALL)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


def test_traced_run_reads_the_slots_lost(monkeypatch):
    code, result = small_run(CELL, monkeypatch, trace=1, traffic=SMALL)
    assert result["correct"], result["checks"]
    assert 2.0 < result["metrics"]["slots_lost_pct.bev"]["value"] < 4.0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(kind, monkeypatch):
    from test_harness_correct import _bev_fault

    _bev_fault(kind, monkeypatch)
    code, result = small_run(CELL, monkeypatch, traffic=SMALL)
    assert not result["correct"], result["checks"]


def test_control_is_not_correct(monkeypatch):
    from harness import checks, main

    seen = {}
    make = main.make_window

    def keep(*a, **k):
        seen["win"] = make(*a, **k)
        return seen["win"]

    monkeypatch.setattr(main, "make_window", keep)
    small_run(CELL, monkeypatch, traffic=SMALL)
    got = seen["win"].check(checks.rules(CELL), "bf16_wire")
    ok, _ = checks.verdict(got["numbers"], checks.rules(CELL)["limits"])
    assert not ok


REHEARSE = r"""
import json, sys
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
import harness.oxford_scene, harness.oxford_bev_window
layout = sorted(m for m in sys.modules if m.split(".")[0] in ("pctpu_torch", "pctpu", "jax"))
from conftest import small_run

class Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)

code, result = small_run({cell!r}, Patch(), seconds=0.2, traffic={small!r})
from harness.main import forbidden_modules
print(json.dumps({{"layout": layout, "forbidden": forbidden_modules(),
                  "port": "pctpu_torch" in sys.modules, "correct": result["correct"]}}))
"""


def test_no_program_in_the_layout_and_no_jax_in_a_run():
    """Importing the layout and the window loads nothing of the program; a
    rehearsed run loads the port and neither JAX nor the JAX package."""
    src = REHEARSE.format(root=ROOT, bench=BENCH, tests=os.path.join(BENCH, "tests"),
                          cell=CELL, small=SMALL)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["layout"] == [] and got["forbidden"] == []
    assert got["port"] and got["correct"]
