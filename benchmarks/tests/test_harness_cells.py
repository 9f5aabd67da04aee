"""Every name in BENCHMARK.json resolves to its files, and the inputs are the
seed's and laid out as the selectors write them."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import BENCH, ROOT

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    from harness import cells

    cell = cells.resolve(name)
    w = next(w for w in BENCHMARK["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["window"] in ("harness.bev_window", "harness.reg_window")
    assert cell.traffic["control"] in ("bf16_wire", "tf32")
    assert os.path.isfile(os.path.join(BENCH, "cells", f"{name}.json"))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for ref in cell.config["reference"]:
        assert os.path.isfile(os.path.join(ROOT, ref))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCHMARK["per_layer"]])
def test_metric_has_a_reader(metric):
    from harness import cells

    assert callable(cells.metric_reader(metric))


def test_configs_and_paths():
    names = {c["name"] for c in BENCHMARK["configs"]}
    assert names == {w["config"] for w in BENCHMARK["workloads"]}
    for c in BENCHMARK["configs"]:
        assert c["file"].startswith("benchmarks/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]
    assert BENCHMARK["paths"] == ["benchmarks"]
    assert BENCHMARK["command"] == ["python3", "benchmarks/run.py"]


def _bev_pool(config_name: str, seed: int):
    from harness import bev_window

    cfg = json.load(open(os.path.join(BENCH, "configs", f"{config_name}.json")))
    return cfg, bev_window.make_pool(cfg, {"pool": 1}, seed)


@pytest.mark.parametrize("config_name", ["kitti-hdl64e", "mulran-os1-64"])
def test_same_seed_same_inputs(config_name):
    _, a = _bev_pool(config_name, 2**31 + 5)
    _, b = _bev_pool(config_name, 2**31 + 5)
    _, c = _bev_pool(config_name, 2**31 + 6)
    for k in a[0]:
        assert np.asarray(a[0][k]).tobytes() == np.asarray(b[0][k]).tobytes()
    assert a[0]["xyz"].tobytes() != c[0]["xyz"].tobytes()


def test_registration_pool_same_seed_same_inputs():
    from harness import reg_window

    cfg = json.load(open(os.path.join(BENCH, "configs", "kitti-hdl64e.json")))
    traffic = {**json.load(open(os.path.join(BENCH, "traffic", "toppart64.json"))),
               "places": 1}
    f1, p1, pairs1 = reg_window.make_pool(cfg, traffic, 3_000_000_123)
    f2, p2, pairs2 = reg_window.make_pool(cfg, traffic, 3_000_000_123)
    assert pairs1 == pairs2 == [(0, 1), (1, 0)]
    for a, b in zip(f1, f2):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
    assert all(np.array_equal(a, b) for a, b in zip(p1, p2))
    yaw = reg_window.true_yaw_deg(p1, 0, 1)
    assert yaw == pytest.approx(-reg_window.true_yaw_deg(p1, 1, 0))


@pytest.mark.parametrize("config_name,ordered", [("kitti-hdl64e", True),
                                                 ("mulran-os1-64", False)])
def test_keyframes_in_the_selectors_layout(config_name, ordered):
    from harness import scene
    from pctpu_torch.config import SensorParams
    from pctpu_torch.ops.ordering import arrays_grid_ordered

    cfg, pool = _bev_pool(config_name, 11)
    params = SensorParams(**cfg["sensor"])
    a = pool[0]
    assert a["xyz"].shape == (params.grid_size, 3)
    assert arrays_grid_ordered(a, params) is ordered
    assert arrays_grid_ordered({**a, "xyz": a["xyz"] * np.float32(scene.perturbation(9))},
                               params) is ordered
    if config_name == "kitti-hdl64e":
        real = a["label"] == -2
        assert np.all(a["intensity"][real] == -1.0)
    else:
        assert int(a["count"]) == params.grid_size
        assert np.any(a["intensity"] > 0)


def _kitti_and_mix(mix: str):
    cfg = json.load(open(os.path.join(BENCH, "configs", "kitti-hdl64e.json")))
    return cfg, json.load(open(os.path.join(BENCH, "traffic", f"{mix}.json")))


@pytest.mark.parametrize("mix", ["toppart64", "whole64"])
def test_registration_pool_follows_its_traffic(mix):
    """A revisit lies within half the keyframe gate along the track, each
    pass within ``lateral_m`` and ``heading_deg``; every parameter the
    generator reads names its source."""
    from harness import reg_window

    cfg, traffic = _kitti_and_mix(mix)
    frames, poses, pairs = reg_window.make_pool(cfg, {**traffic, "places": 2}, 7)
    assert len(frames) == 4 and len(pairs) == 4
    for p in range(2):
        a, b = poses[2 * p], poses[2 * p + 1]
        assert a[0, 3] == p * traffic["place_spacing_m"]
        assert abs(b[0, 3] - a[0, 3]) <= traffic["gate_m"] / 2
        for pose in (a, b):
            assert abs(pose[1, 3]) <= traffic["lateral_m"]
            yaw = np.degrees(np.arctan2(pose[1, 0], pose[0, 0]))
            assert abs(yaw) <= traffic["heading_deg"]
    read = {"place_spacing_m", "gate_m", "lateral_m", "heading_deg", "guess_bin_deg",
            "pair_batch", "places", "world_seed"}
    assert read <= set(traffic["sources"])
    assert ("depth" in traffic) == (traffic["stage"] == "top_part")


@pytest.mark.parametrize("yaw", [0.0, 2.9, 3.1, -8.99, 179.0, -177.5])
def test_angle_guess_is_the_nearest_bin(yaw):
    from harness import reg_window

    g = reg_window.angle_guess_deg(yaw, 6.0)
    assert abs(g - yaw) <= 3.0
    assert g / 6.0 == round(g / 6.0)


def test_configuration_keys_are_wired():
    """capacity_step sets the capacity, a pool over ``keyframes`` is refused,
    and top-flatten settings the drivers cannot take are refused."""
    from harness import bev_window, reg_window

    cfg, traffic = _kitti_and_mix("toppart64")
    frames = [{"x": np.zeros(9000)}]
    assert reg_window.capacity_of(frames, cfg["registration"]["capacity_step"]) == 16384
    assert reg_window.capacity_of(frames, 1000) == 9000
    with pytest.raises(ValueError):
        reg_window.make_pool({**cfg, "keyframes": 3}, {**traffic, "places": 2}, 7)
    with pytest.raises(ValueError):
        bev_window.make_pool({**cfg, "keyframes": 1}, {"pool": 2}, 7)
    reg_window.port_config(cfg, "top_part")
    changed = {**cfg["registration"],
               "top_flatten": {**cfg["registration"]["top_flatten"], "num_grid_x": 12}}
    with pytest.raises(ValueError):
        reg_window.port_config({**cfg, "registration": changed}, "top_part")


def test_window_driver_found_by_name(monkeypatch):
    """The traffic file's ``window`` names the module whose ``Window`` runs
    the cell: a new kind of traffic is new files only."""
    import sys
    import types

    from harness import cells, main

    made = {}

    class Window:
        def __init__(self, config, traffic, seed, device, span):
            made.update(config=config, traffic=traffic, seed=seed)

    monkeypatch.setitem(sys.modules, "harness.stand_in_window",
                        types.SimpleNamespace(Window=Window))
    cell = cells.resolve("mulran-os1-64.bev")
    cell.traffic = {**cell.traffic, "window": "harness.stand_in_window"}
    assert isinstance(main.make_window(cell, 5, None, None), Window)
    assert made["seed"] == 5 and made["config"]["name"] == "mulran-os1-64"
