"""The BEV path on Oxford-layout keyframes against the benchmark's plain
reference (``benchmarks/reference/bev_chain.py``), bit for bit.

An Oxford keyframe holds the returns of one sweep in firing order, and the
sensor fires more often a revolution than the selector has columns, so in
every ring some columns get two distinct returns and the later one must win
(``getOrderedCloud``).  Here the sweep is cut to an 8 x 132 grid fired 136
times a revolution (the HDL-32E's 1,085 firings into 1,056 columns, scaled),
on seeded random scenes: a ground plane under walls of random height and
range.  Rows and columns follow the Oxford selector's rule: the row from the
elevation, top ring first, the column from the semi-positive azimuth,
wrapped."""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from pctpu_torch.config import GroundConfig, MultiBevConfig, SensorParams, SingleBevConfig
from pctpu_torch.ops.preprocess import preprocess_batch
from pctpu_torch.pipelines.multi_bev import _to_device, _to_host, _wire

_REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "benchmarks", "reference", "bev_chain.py")
_spec = importlib.util.spec_from_file_location("bev_chain_reference", _REF)
bev_chain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bev_chain)

N_SCAN, HORIZON, FIRINGS = 8, 132, 136
PARAMS = SensorParams(n_scan=N_SCAN, horizon_scan=HORIZON, ground_upper_scan=5, height_res=0.5)
TOP_DEG, STEP_DEG = 5.0, 4.0  # ring elevations 5, 1, ..., -23 degrees
SENSOR_HEIGHT = 1.73
CAPACITY = N_SCAN * FIRINGS  # every ray of a sweep: the loader pads to it
CPU = torch.device("cpu")


def _sensor() -> dict:
    return dataclasses.asdict(PARAMS)


def _configs() -> tuple[dict, dict, dict]:
    """The ground, multi-BEV and single-BEV settings the port runs, as the
    reference takes them."""
    return tuple(dataclasses.asdict(c()) for c in (GroundConfig, MultiBevConfig, SingleBevConfig))


def sweep(seed: int) -> dict:
    """One Oxford-layout keyframe of a seeded scene, as the loader hands it
    over (on-disk widths, padded to ``CAPACITY``, ``count``): the returns
    firing by firing, lowest ring first in a firing."""
    rng = np.random.default_rng(seed)
    el = np.radians(TOP_DEG - STEP_DEG * np.arange(N_SCAN))[::-1]
    az = np.arange(FIRINGS) * (2.0 * np.pi / FIRINGS)
    # walls: a range and a height for each run of firings
    edges = np.sort(rng.choice(np.arange(1, FIRINGS), 12, replace=False))
    run = np.searchsorted(edges, np.arange(FIRINGS), side="right")
    wall_r = rng.uniform(4.0, 40.0, 13)[run][:, None]
    wall_h = rng.uniform(0.5, 8.0, 13)[run][:, None]
    tan = np.tan(el)[None, :]
    ground_r = np.where(tan < 0, SENSOR_HEIGHT / np.maximum(-tan, 1e-9), np.inf)
    at_wall = SENSOR_HEIGHT + wall_r * tan
    t = np.where((at_wall >= 0) & (at_wall <= wall_h) & (wall_r < ground_r), wall_r, ground_r)
    hit = np.isfinite(t) & (t < 100.0) & (rng.random(t.shape) >= 0.07)
    t = t + rng.normal(0.0, 0.02, t.shape)
    d = np.stack(np.broadcast_arrays(np.cos(el)[None] * np.cos(az)[:, None],
                                     np.cos(el)[None] * np.sin(az)[:, None],
                                     np.sin(el)[None] * np.ones_like(az)[:, None]), -1)
    pts = (d * np.where(hit, t, 0.0)[..., None]).astype(np.float32)[hit]
    inten = rng.uniform(0.05, 1.0, hit.shape).astype(np.float32)[hit]
    return loader_arrays(pts, inten)


def loader_arrays(pts: np.ndarray, inten: np.ndarray) -> dict:
    """(N, 3) f32 returns in firing order → the loader's arrays, row and col
    by the Oxford selector's rule at this grid."""
    n = len(pts)
    x, y, z = (pts[:, i].astype(np.float64) for i in range(3))
    elev = np.degrees(np.arctan2(z, np.hypot(x, y)))
    row = np.clip(np.floor((TOP_DEG - elev) / STEP_DEG + 0.5), 0, N_SCAN - 1).astype(np.int64)
    semi = np.degrees(np.arctan2(y, x)) % 360.0
    col = np.floor(semi / 360.0 * HORIZON + 0.5).astype(np.int64) % HORIZON
    out = {"xyz": np.zeros((CAPACITY, 3), np.float32),
           "intensity": np.zeros(CAPACITY, np.float32),
           "row": np.zeros(CAPACITY, np.uint16), "col": np.zeros(CAPACITY, np.uint16),
           "t": np.zeros(CAPACITY, np.uint32), "label": np.zeros(CAPACITY, np.int16),
           "count": np.int32(n)}
    out["xyz"][:n] = pts
    out["intensity"][:n] = inten
    out["row"][:n] = row
    out["col"][:n] = col
    out["label"][:n] = -2
    return out


def collisions(a: dict) -> list[tuple[int, int]]:
    """(earlier, later) index pairs of returns that share a slot."""
    n = int(a["count"])
    slot = a["row"][:n].astype(np.int64) * HORIZON + a["col"][:n]
    first: dict[int, int] = {}
    out = []
    for i, s in enumerate(slot.tolist()):
        if s in first:
            out.append((first[s], i))
        first[s] = i
    return out


def swapped(a: dict) -> dict:
    """The keyframe with each colliding pair's order swapped: a first-wins
    ordering of ``a`` gives the last-wins answer of this one."""
    out = {k: np.array(v, copy=True) for k, v in a.items()}
    for i, j in collisions(a):
        for k in ("xyz", "intensity", "row", "col", "t", "label"):
            out[k][[i, j]] = out[k][[j, i]]
    return out


def stack(clouds: list[dict]) -> dict:
    return {k: np.stack([c[k] for c in clouds]) for k in clouds[0]}


def port(clouds: list[dict]) -> dict:
    labeled, multi, single = preprocess_batch(
        _to_device(stack(clouds), CPU), PARAMS, GroundConfig(), MultiBevConfig(),
        SingleBevConfig())
    return _to_host([{**_wire(labeled), "multi": multi, "single": single}])


def reference(a: dict) -> dict:
    ground, multi, single = _configs()
    return next(bev_chain.answers(a, _sensor(), ground, multi, single))


def verdict(got: dict, b: int, a: dict) -> dict:
    ground, multi, single = _configs()
    return bev_chain.judge({k: got[k][b] for k in bev_chain.KEYS}, a, _sensor(), ground,
                           multi, single)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seeds", [(3_000_000_001, 3_000_000_002, 3_000_000_003),
                                   (2**31 + 5, 2**31 + 6)])
def test_port_equals_the_reference(seeds):
    """The wire, the labels and both BEVs of a batch of Oxford keyframes,
    each bit for bit the reference's; the scenes have real ground, real
    collisions and drawn BEVs."""
    clouds = [sweep(s) for s in seeds]
    got = port(clouds)
    for b, a in enumerate(clouds):
        v = verdict(got, b, a)
        assert v["ok"], v["diff"]
        assert collisions(a)
        assert np.any(got["label"][b] == 0) and np.any(got["label"][b] == -2)
        assert got["multi"][b].any() and got["single"][b].any()


def test_the_later_return_wins_a_shared_slot():
    """Two distinct returns in one slot: the ordered slot holds the later
    one, every field of it, and the earlier is gone from the cloud."""
    a = sweep(17)
    (i, j), *_ = collisions(a)
    got = port([a])
    slot = int(a["row"][j]) * HORIZON + int(a["col"][j])
    assert not np.array_equal(a["xyz"][i], a["xyz"][j])
    np.testing.assert_array_equal(got["xyz"][0, slot].view(np.uint32),
                                  a["xyz"][j].view(np.uint32))
    assert got["intensity"][0, slot] == a["intensity"][j]
    held = got["xyz"][0].view(np.uint32)
    assert not np.any(np.all(held == a["xyz"][i].view(np.uint32), axis=1))
    assert verdict(got, 0, a)["ok"]


@pytest.mark.parametrize("seed", [23, 2**31 + 29])
def test_a_first_wins_ordering_is_caught(seed):
    """With each colliding pair's order swapped the reference answers
    otherwise, so an ordering that kept the first return would be judged
    off; the port follows the swap too."""
    a = sweep(seed)
    b = swapped(a)
    want_a, want_b = reference(a), reference(b)
    diff = bev_chain.differing(want_b, want_a)
    assert diff["xyz"] > 0 and diff["intensity"] > 0
    assert not bev_chain.judge(want_b, a, _sensor(), *_configs())["ok"]
    got = port([a, b])
    assert verdict(got, 0, a)["ok"] and verdict(got, 1, b)["ok"]
