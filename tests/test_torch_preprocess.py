"""pctpu_torch's BEV slice (ordering, ground marking, BEV rasters,
preprocess) against pctpu on the same numpy inputs, on the CPU.

pctpu's ops run as its own CPU tests run them (jitted XLA on the CPU; no
Pallas on this path).  Outputs must be bit-equal, field by field and pixel
by pixel; tolerance-mode sector sums are held to pctpu's own window
(tests/test_compat_tolerance.py: averages 1e-4, counts 1e-5)."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import pctpu.cloud as jcloud
from pctpu.config import GroundConfig as JGroundConfig
from pctpu.ops import bev as jbev
from pctpu.ops import ground as jground
from pctpu.ops import ordering as jordering
from pctpu.ops import preprocess as jpre
from pctpu.ops import rounding as jrounding
from pctpu_torch import from_numpy
from pctpu_torch.config import GroundConfig, SensorParams, get_sensor_params
from pctpu_torch.io.csvfmt import format_csv_bytes
from pctpu_torch.ops import bev, ground, ordering, preprocess, rounding
from pctpu_torch.runtime import profiler

from . import ref_impl
from .test_ops_preprocess import SMALL as JSMALL
from .test_ops_preprocess import ordered_ref_arrays, random_points, to_cloud

SMALL = SensorParams(n_scan=16, horizon_scan=32, ground_upper_scan=10, height_res=0.5)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hashes.json")


def port(jc) -> "object":
    """A pctpu Cloud (one cloud) as a port Cloud."""
    return from_numpy(jcloud.to_numpy(jc), device="cpu")


def port_batch(jcs):
    """pctpu clouds stacked into a port Cloud with a (B,) count."""
    ds = [jcloud.to_numpy(c) for c in jcs]
    one = [from_numpy(d, device="cpu") for d in ds]
    fields = {k: torch.stack([getattr(c, k) for c in one])
              for k in ("xyz", "intensity", "row", "col", "t", "label")}
    return one[0].replace(count=torch.tensor([d["count"] for d in ds]), **fields)


def assert_cloud_bits(got, want_jc):
    want = jcloud.to_numpy(want_jc)
    np.testing.assert_array_equal(got.xyz.numpy().view(np.uint32), want["xyz"].view(np.uint32))
    np.testing.assert_array_equal(got.intensity.numpy().view(np.uint32),
                                  want["intensity"].view(np.uint32))
    for k in ("row", "col", "label"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k], err_msg=k)
    np.testing.assert_array_equal(got.t.numpy(), want["t"].astype(np.int64))


def ground_scene(seed, n=400, neg1=0.2):
    rng = np.random.default_rng(seed)
    points = random_points(rng, n, JSMALL, intensity_neg1_frac=neg1)
    for p in points:
        if rng.random() < 0.6:
            p["z"] = float(np.float32(rng.uniform(-2.1, -1.7)))
        if rng.random() < 0.05:
            p["z"] = float(np.float32(rng.uniform(50.0, 70.0)))  # layer out of range
    return points


def test_bev_cell_bit_equal():
    rng = np.random.default_rng(0)
    edges = np.array([-112.5, -112.49999, -112.50001, -111.5, 0.0, -0.0, 110.5, 111.5,
                      111.99999, 112.0, np.nan, np.inf, -np.inf, 3e9, -3e9, 1e38],
                     np.float32)
    coords = np.concatenate([rng.uniform(-130, 130, 20000).astype(np.float32), edges,
                             np.round(rng.uniform(-130, 130, 2000)).astype(np.float32) - 0.5])
    want = np.asarray(jrounding.bev_cell(coords, 112.0, 1.0))
    got = rounding.bev_cell(torch.from_numpy(coords), 112.0, 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    half = np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.49999, 2.50001, np.nan])
    np.testing.assert_array_equal(rounding.c_round(torch.from_numpy(half)).numpy(),
                                  np.asarray(jrounding.c_round(half)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordering_matches_pctpu(seed):
    points = random_points(np.random.default_rng(seed), 300, JSMALL)
    jc = to_cloud(points, capacity=320)  # 20 padding slots
    assert_cloud_bits(ordering.get_ordered_cloud(port(jc), SMALL),
                      jordering.get_ordered_cloud(jc, JSMALL))


def test_ordering_last_wins_negzero_nan_payload():
    """Collisions keep the last point; -0.0 and a NaN payload come through
    bit for bit (the gather moves int32 bits, not float values)."""
    points = random_points(np.random.default_rng(3), 40, JSMALL)
    for p in points[:6]:
        p["row"], p["col"] = 5, 7
    jc = to_cloud(points)
    d = {k: np.array(v) for k, v in jcloud.to_numpy(jc).items()}
    nan = np.array([0x7FC01234, 0xFFA00001], np.uint32).view(np.float32)
    d["xyz"][5, 0] = nan[0]
    d["xyz"][7, 2] = -0.0
    d["intensity"][8] = nan[1]
    d["t"][9] = 0xFFFFFFF0
    jc = jcloud.make_cloud(d["xyz"], intensity=d["intensity"], row=d["row"], col=d["col"],
                           t=d["t"], label=d["label"])
    got = ordering.get_ordered_cloud(port(jc), SMALL)
    assert_cloud_bits(got, jordering.get_ordered_cloud(jc, JSMALL))
    assert got.xyz[5 * SMALL.horizon_scan + 7, 0].numpy().view(np.uint32) == 0x7FC01234


def test_grid_ordered_checks_and_fast_path():
    """The host layout checks agree with pctpu (including the -0.0 rule),
    and the preordered fast path equals the general ordering, slot 0 too."""
    points = random_points(np.random.default_rng(7), 300, JSMALL, intensity_neg1_frac=0.1)
    dense = jordering.get_ordered_cloud(to_cloud(points), JSMALL)
    for jc in (to_cloud(points), dense):
        assert ordering.is_grid_ordered(port(jc), SMALL) == jordering.is_grid_ordered(jc, JSMALL)
    assert ordering.is_grid_ordered(port(dense), SMALL)
    assert_cloud_bits(preprocess._reorder_preordered(port(dense), SMALL),
                      jpre._reorder_preordered(dense, JSMALL))

    g = SMALL.grid_size
    xyz = np.zeros((g, 3), np.float32)
    xyz[0] = [5.0, 1.0, -1.9]  # a real point at (0, 0) loses to the empty slots
    label = np.zeros(g, np.int32)
    label[0] = -2
    jc = jcloud.make_cloud(xyz, label=label)
    fast = preprocess._reorder_preordered(port(jc), SMALL)
    assert_cloud_bits(fast, jordering.get_ordered_cloud(jc, JSMALL))
    assert fast.xyz[0].tolist() == [0.0, 0.0, 0.0]

    xyz2 = np.zeros((g, 3), np.float32)
    xyz2[g - 1, 0] = -0.0
    arrays = {"xyz": xyz2, "intensity": np.zeros(g, np.float32),
              "row": np.zeros(g, np.uint16), "col": np.zeros(g, np.uint16),
              "t": np.zeros(g, np.uint32), "label": np.zeros(g, np.int16), "count": g}
    assert not ordering.arrays_grid_ordered(arrays, SMALL)
    assert jordering.arrays_grid_ordered(arrays, JSMALL) is False
    neg = ordering.get_ordered_cloud(port(jcloud.make_cloud(xyz2)), SMALL)
    assert np.signbit(neg.xyz[0, 0].numpy())


def _dense_arrays(seed=11):
    """A dense grid-ordered cloud in the loader's dict form: empty slots
    all-zero, every other slot's point in place."""
    d = jcloud.to_numpy(jordering.get_ordered_cloud(
        to_cloud(random_points(np.random.default_rng(seed), 400, JSMALL)), JSMALL))
    return {k: np.array(v) for k, v in d.items()}


def _grid_case(name):
    """(the case's cloud in the dict form, pctpu's answer on it)."""
    g, h = SMALL.grid_size, SMALL.horizon_scan
    d = _dense_arrays()
    empty = np.flatnonzero(~d["xyz"].view(np.uint32).any(axis=1))
    real = np.flatnonzero(d["xyz"].view(np.uint32).any(axis=1))
    if name == "raw":
        rng = np.random.default_rng(5)
        d = jcloud.to_numpy(to_cloud(random_points(rng, g, JSMALL)))
        d = {k: np.array(v) for k, v in d.items()}
        d["row"][0], d["col"][0] = 0, 0  # slot 0 in place; slot 1 decides
    elif name == "dense":
        pass
    elif name == "all_empty":
        d = {k: np.zeros_like(v) for k, v in d.items()}
        d["count"] = g
    elif name == "negzero_last_slot":
        last = g - 1
        for k in ("xyz", "intensity", "row", "col", "t", "label"):
            d[k][last] = 0
        d["xyz"][last, 2] = -0.0
    elif name == "moved_in_last_row":
        s = real[real >= g - h][0]
        d["col"][s] = (d["col"][s] + 1) % h
    elif name == "nan_payload_intensity":
        s = empty[len(empty) // 2]
        assert s >= h
        d["intensity"][s] = np.array([0x7FC01234], np.uint32).view(np.float32)[0]
    elif name == "empty_first_row_moved_later":
        for k in ("xyz", "intensity", "row", "col", "t", "label"):
            d[k][:h] = 0
        d["row"][h:] = (d["row"][h:] + 1) % SMALL.n_scan
    elif name == "negative_row_later":
        d["row"][real[-1]] = -1
    elif name == "negative_row_first":
        d["row"][real[real < h][0]] = -1
    elif name == "count_short":
        d["count"] = g - 1
    elif name == "xyz_longer":
        d = {k: (np.concatenate([v, np.zeros_like(v[:3])]) if k != "count" else g)
             for k, v in d.items()}
    want = jordering.arrays_grid_ordered(d, JSMALL)
    return d, want


GRID_CASES = {  # name: (pctpu's answer, where the port decides)
    "raw": (False, "early"), "dense": (True, "full"), "all_empty": (True, "full"),
    "negzero_last_slot": (False, "full"), "moved_in_last_row": (False, "full"),
    "nan_payload_intensity": (False, "full"), "empty_first_row_moved_later": (False, "full"),
    "negative_row_later": (False, "full"), "negative_row_first": (False, "early"),
    "count_short": (False, None), "xyz_longer": (False, None),
}


@pytest.mark.parametrize("name,form", [
    (name, form) for name in GRID_CASES for form in ("dict-uint16", "dict-int32", "cloud")
    # uint16 holds no negative row
    if not (form == "dict-uint16" and name.startswith("negative_row"))
])
def test_grid_ordered_equals_pctpu(name, form):
    """arrays_grid_ordered and is_grid_ordered give pctpu's bool on every
    case, and decide where the case says: the first row of slots, every
    slot, or neither (the shape and count guards)."""
    d, want = _grid_case(name)
    assert want is GRID_CASES[name][0]
    if form.startswith("dict"):
        dt = np.uint16 if form == "dict-uint16" else np.int32
        arrays = {**d, "row": d["row"].astype(dt), "col": d["col"].astype(dt),
                  "label": d["label"].astype(np.int16)}
        assert jordering.arrays_grid_ordered(arrays, JSMALL) is want
        with profiler.recording() as rec:
            got = ordering.arrays_grid_ordered(arrays, SMALL)
        assert len(rec.named("ordering.grid_check")) == 1
    else:
        jc = jcloud.make_cloud(d["xyz"], intensity=d["intensity"], row=d["row"], col=d["col"],
                               t=d["t"], label=d["label"], count=d["count"])
        assert jordering.is_grid_ordered(jc, JSMALL) is want
        cloud = from_numpy(d, device="cpu")
        assert cloud.row.dtype == torch.int32
        with profiler.recording() as rec:
            got = ordering.is_grid_ordered(cloud, SMALL)
    assert got is want
    route = GRID_CASES[name][1]
    assert rec.totals() == ({} if route is None else {f"ordering.grid_check.{route}": 1})


@pytest.mark.parametrize("compat", ["bitexact", "tolerance"])
@pytest.mark.parametrize("seed,neg1", [(0, 0.2), (1, 0.0), (2, 1.0), (3, 0.5)])
def test_mark_ground_matches_pctpu(seed, neg1, compat):
    jc = jordering.get_ordered_cloud(to_cloud(ground_scene(seed, neg1=neg1)), JSMALL)
    jl, jgm = jground.mark_ground(jc, JSMALL, compat=compat)
    pl, pgm = ground.mark_ground(port(jc), SMALL, compat=compat)
    np.testing.assert_array_equal(pgm.numpy(), np.asarray(jgm))
    np.testing.assert_array_equal(pl.label.numpy(), np.asarray(jl.label))


def test_ground_kitti_intensity_quirk_and_oracle():
    """Every real point at intensity -1 (the KITTI selector quirk): the
    (col-2) fallback walks into the previous row; labels and ground_mat
    equal pctpu's and the loop oracle's."""
    points = random_points(np.random.default_rng(7), 300, JSMALL, intensity_neg1_frac=1.0)
    ref_cloud, _ = ordered_ref_arrays(points, JSMALL)
    gm_ref = ref_impl.mark_ground_ref(ref_cloud, 16, 32, 10)
    jc = jordering.get_ordered_cloud(to_cloud(points), JSMALL)
    jl, jgm = jground.mark_ground(jc, JSMALL)
    pl, pgm = ground.mark_ground(port(jc), SMALL)
    np.testing.assert_array_equal(pgm.numpy(), gm_ref)
    np.testing.assert_array_equal(pgm.numpy(), np.asarray(jgm))
    np.testing.assert_array_equal(pl.label.numpy(), [p["label"] for p in ref_cloud])


def test_count_epsilon_knife_edge():
    """pctpu's engineered scene where exact_count + 0.01 and the sequential
    (0.01 + 1) + 1 + … sum veto differently
    (tests/test_ops_preprocess.py::test_count_epsilon_accumulation_order_knife_edge):
    bit-exact mode matches the oracle; tolerance mode keeps pctpu's
    tolerance-mode labels."""
    v, z_knife = np.float32(1.0013), np.float32(1.3009875)
    pts = [{"x": 1.5, "y": 1.0, "z": float(v), "intensity": 0.5, "row": r, "col": c,
            "t": 0, "label": -2}
           for r, c in [(15, c) for c in range(17)] + [(14, c) for c in range(16)]]
    pts += [{"x": 3.5, "y": 1.0, "z": float(z_knife), "intensity": 0.5, "row": r,
             "col": 20, "t": 0, "label": -2} for r in (14, 15)]
    for (sx, sy), cols in (((5.5, 1.0), (22, 23)), ((3.5, -1.0), (24, 25)),
                           ((3.5, 3.0), (26, 27))):
        pts += [{"x": sx, "y": sy, "z": 1.4, "intensity": 0.5, "row": r, "col": c,
                 "t": 0, "label": -2} for c in cols for r in (14, 15)]
    ref_cloud, _ = ordered_ref_arrays(pts, JSMALL)
    ref_impl.mark_ground_ref(ref_cloud, 16, 32, 10)
    jc = jordering.get_ordered_cloud(to_cloud(pts), JSMALL)
    exact, _ = ground.mark_ground(port(jc), SMALL)
    np.testing.assert_array_equal(exact.label.numpy(), [p["label"] for p in ref_cloud])
    tol, _ = ground.mark_ground(port(jc), SMALL, compat="tolerance")
    jtol, _ = jground.mark_ground(jc, JSMALL, compat="tolerance")
    np.testing.assert_array_equal(tol.label.numpy(), np.asarray(jtol.label))
    assert (tol.label.numpy() != exact.label.numpy()).any()  # the knife edge itself


@pytest.mark.parametrize("margin", [0.30, 0.25, 0.1, 0.7])
def test_rooftop_margin_strictness(margin):
    assert ground._strict_gt_f32_threshold(margin) == jground._strict_gt_f32_threshold(margin)
    jc = jordering.get_ordered_cloud(to_cloud(ground_scene(int(margin * 100))), JSMALL)
    jl, _ = jground.mark_ground(jc, JSMALL, JGroundConfig(rooftop_margin=margin))
    pl, _ = ground.mark_ground(port(jc), SMALL, GroundConfig(rooftop_margin=margin))
    np.testing.assert_array_equal(pl.label.numpy(), np.asarray(jl.label))


def _sector_inputs(seed, b=3, p=5000):
    cfg = GroundConfig()
    rng = np.random.default_rng(seed)
    # a few hot sectors with ≥ 32 points each, where the epsilon order matters
    sector = np.where(rng.random((b, p)) < 0.3, rng.integers(1800, 1810, (b, p)),
                      rng.integers(0, cfg.grid_rows * cfg.grid_cols, (b, p))).astype(np.int32)
    z = rng.uniform(-2.5, 0.5, (b, p)).astype(np.float32)
    ground_ = rng.random((b, p)) < 0.6
    return cfg, sector, z, ground_


def test_sector_sums_bitexact():
    """The in-order sums (sorted points from (0, epsilon), the segment-sum
    twin) are bit-equal to pctpu's sequential scatter-add, per cloud of a
    batch."""
    cfg, sector, z, ground_ = _sector_inputs(0)
    got = ground._grid_sums_bitexact(torch.from_numpy(sector), torch.from_numpy(z),
                                     torch.from_numpy(ground_), cfg).numpy()
    for bi in range(sector.shape[0]):
        want = np.asarray(jground._grid_sums_bitexact(sector[bi], z[bi], ground_[bi],
                                                      JGroundConfig()))
        np.testing.assert_array_equal(got[bi].view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [2, 3])
def test_sector_sums_rows_need_no_padding(seed):
    """The segment-sum rows of the sector sums: one (z, 1) row a point, no
    head rows; ids ascending with the non-ground points past the last
    sector; a stable order.  Started at (0, epsilon) they give pctpu's bits,
    a sector without ground points (0, epsilon) itself, and the batch equals
    its clouds one by one."""
    cfg, sector, z, ground_ = _sector_inputs(seed, b=2, p=3000)
    nsec = cfg.grid_rows * cfg.grid_cols
    args = [torch.from_numpy(a) for a in (sector, z, ground_)]
    values, seg, order = ground.sector_sums_rows(*args, cfg)
    assert values.shape == (2 * 3000, 2) and seg.dtype == torch.int32
    assert (values[:, 1] == 1).all() and (seg[1:] >= seg[:-1]).all()
    assert int((seg < 2 * nsec).sum()) == int(ground_.sum())
    same = seg[1:] == seg[:-1]
    assert (order[1:][same] > order[:-1][same]).all()  # point order inside a segment
    got = ground._grid_sums_bitexact(*args, cfg).numpy()
    eps = np.float32(cfg.count_epsilon)
    for bi in range(2):
        want = np.asarray(jground._grid_sums_bitexact(sector[bi], z[bi], ground_[bi],
                                                      JGroundConfig()))
        np.testing.assert_array_equal(got[bi].view(np.uint32), want.view(np.uint32))
        empty = np.bincount(sector[bi][ground_[bi]], minlength=nsec) == 0
        assert empty.any() and (got[bi][empty] == [0.0, eps]).all()
        one = ground._grid_sums_bitexact(*(a[bi:bi + 1] for a in args), cfg).numpy()
        np.testing.assert_array_equal(one[0].view(np.uint32), got[bi].view(np.uint32))


def test_sector_sums_tolerance_window():
    cfg, sector, z, ground_ = _sector_inputs(1)
    srow, scol = sector // cfg.grid_cols, sector % cfg.grid_cols
    got = ground._grid_sums_tolerance(*(torch.from_numpy(a) for a in (srow, scol, z, ground_)),
                                      cfg).numpy()
    for bi in range(sector.shape[0]):
        exact = np.asarray(jground._grid_sums_bitexact(sector[bi], z[bi], ground_[bi],
                                                       JGroundConfig()))
        np.testing.assert_allclose(got[bi, :, 0] / got[bi, :, 1], exact[:, 0] / exact[:, 1],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[bi, :, 1], exact[:, 1], rtol=0, atol=1e-5)
        jtol = np.asarray(jground._grid_sums_tolerance(srow[bi], scol[bi], z[bi], ground_[bi],
                                                       JGroundConfig()))
        np.testing.assert_array_equal(got[bi, :, 1], jtol[:, 1])  # counts: exact integers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bev_rasters_match_pctpu(seed):
    jc = jordering.get_ordered_cloud(to_cloud(ground_scene(seed, n=600, neg1=0.1)), JSMALL)
    jl, _ = jground.mark_ground(jc, JSMALL)
    pl = port(jl)
    jm, js = jbev.fused_multi_single_bev(jl, 0.5)
    pm, ps = bev.fused_multi_single_bev(pl, 0.5)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(bev.multi_bev(pl, 0.5).numpy(), np.asarray(jbev.multi_bev(jl, 0.5)))
    np.testing.assert_array_equal(bev.single_bev(pl).numpy(), np.asarray(jbev.single_bev(jl)))


@pytest.mark.parametrize("max_range,layers", [(50.0, 24), (50.5, 1), (16.0, 7)])
def test_bev_rasters_other_grids_match_pctpu(max_range, layers):
    """Grids of 100², 101² and 32² cells and 1 to 24 layers (the shapes the
    card tests give the raster kernels) agree with pctpu's fused raster."""
    from pctpu.config import MultiBevConfig as JMulti
    from pctpu.config import SingleBevConfig as JSingle
    from pctpu_torch.config import MultiBevConfig, SingleBevConfig

    rng = np.random.default_rng(int(max_range * 2))
    n = 500
    xyz = rng.uniform(-max_range - 5, max_range + 5, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-4.0, 12.0, n)
    xyz[:4, 0] = [-max_range, max_range, max_range - 1.0, -max_range - 0.5]  # the grid's edges
    label = np.where(rng.random(n) > 0.3, -2, 0).astype(np.int32)
    jc = jcloud.make_cloud(xyz, label=label)
    jm, js = jbev.fused_multi_single_bev(jc, 0.5, JMulti(max_range=max_range, num_layers=layers),
                                         JSingle(max_range=max_range))
    pm, ps = bev.fused_multi_single_bev(port(jc), 0.5,
                                        MultiBevConfig(max_range=max_range, num_layers=layers),
                                        SingleBevConfig(max_range=max_range))
    assert pm.shape == (layers, int(2 * max_range), int(2 * max_range))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert int(pm.count_nonzero()) > 0 and int(ps.count_nonzero()) > 0


def test_raster_kernels_need_cuda_tensors():
    """No fallback: the raster launchers refuse a CPU cloud (only
    ``fused_multi_single_bev`` takes the twin for one), and the fused entry
    refuses two grids that differ."""
    from pctpu_torch.config import MultiBevConfig, SingleBevConfig

    cloud = port(jcloud.make_cloud(np.zeros((4, 3), np.float32)))
    for fn in (bev.fused_multi_single_bev_v1, bev._raster_launcher, bev.atomics_sent):
        with pytest.raises(ValueError, match="CUDA"):
            fn(cloud, 0.5)
    for fn in (bev.fused_multi_single_bev, bev.fused_multi_single_bev_v1):
        with pytest.raises(ValueError, match="geometry"):
            fn(cloud, 0.5, MultiBevConfig(max_range=50.0), SingleBevConfig())


def test_bev_corrupt_values_match_pctpu():
    """NaN / ±inf / huge coordinates land where pctpu puts them (XLA's
    saturating f32 → int32: NaN → cell 0)."""
    rng = np.random.default_rng(5)
    n = 64
    xyz = rng.uniform(-120, 120, (n, 3)).astype(np.float32)
    bad = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 1e38], np.float32)
    xyz[:18] = np.stack([np.resize(bad, 18), np.resize(bad[::-1], 18),
                         np.resize(np.roll(bad, 2), 18)], 1)
    jc = jcloud.make_cloud(xyz, label=np.full(n, -2, np.int32))
    jm, js = jbev.fused_multi_single_bev(jc, 0.25)
    pm, ps = bev.fused_multi_single_bev(port(jc), 0.25)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("compat", ["bitexact", "tolerance"])
def test_preprocess_batch_matches_pctpu(compat):
    """A batch of three raw clouds (duplicates, padding) and the preordered
    fast path of three dense clouds: labeled clouds and both BEVs equal."""
    raw = [to_cloud(ground_scene(s, n=500, neg1=0.15), capacity=520) for s in (10, 11, 12)]
    dense = [jordering.get_ordered_cloud(c, JSMALL) for c in raw]
    for clouds, ordered in ((raw, False), (dense, True)):
        jl, jm, js = jpre.preprocess_batch(jcloud.stack_clouds(clouds), JSMALL,
                                           assume_ordered=ordered, compat=compat)
        pl, pm, ps = preprocess.preprocess_batch(port_batch(clouds), SMALL,
                                                 assume_ordered=ordered, compat=compat)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pl.label.numpy(), np.asarray(jl.label))
        np.testing.assert_array_equal(pl.xyz.numpy().view(np.uint32),
                                      np.asarray(jl.xyz).view(np.uint32))
        one = preprocess.preprocess_cloud(port(clouds[1]), SMALL, assume_ordered=ordered,
                                          compat=compat)
        np.testing.assert_array_equal(one[1].numpy(), np.asarray(jm)[1])


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_golden_hashes_small_sensor():
    """tests/test_golden.py's small-sensor fixture, rebuilt in numpy,
    reproduces the committed ground_mat / labels / multi_bev_bin /
    single_bev_csv hashes through the port alone."""
    from pctpu_torch import make_cloud

    rng = np.random.default_rng(12345)
    n = 600
    r = rng.uniform(2, 60, n).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    is_ground = rng.random(n) < 0.5
    z = np.where(is_ground, rng.uniform(-2.1, -1.7, n), rng.uniform(-1, 5, n)).astype(np.float32)
    xyz = np.stack([r * np.cos(az), r * np.sin(az), z], 1).astype(np.float32)
    intensity = np.where(rng.random(n) < 0.2, -1.0, rng.random(n)).astype(np.float32)
    cloud = make_cloud(xyz, intensity=intensity, row=rng.integers(0, 16, n),
                       col=rng.integers(0, 32, n), label=np.full(n, -2, np.int32), device="cpu")
    ordered = ordering.get_ordered_cloud(cloud, SMALL)
    labeled, gm = ground.mark_ground(ordered, SMALL)
    want = _golden()
    assert _sha(gm.numpy().tobytes()) == want["ground_mat"]
    assert _sha(labeled.label.numpy().astype(np.int16).tobytes()) == want["labels"]
    assert _sha(bev.multi_bev(labeled, 0.5).numpy().tobytes()) == want["multi_bev_bin"]
    assert _sha(format_csv_bytes(bev.single_bev(labeled).numpy())) == want["single_bev_csv"]


def test_golden_hashes_hdl64e():
    """The full HDL-64E fused production path (grid-ordered fast path,
    swept-band ground, fused BEV) at 64×2083 reproduces the committed
    ``hdl64e_*`` hashes (tests/test_golden.py:62-107, rebuilt in numpy)."""
    from pctpu_torch import make_cloud

    params = get_sensor_params("HDL_64E")
    rng = np.random.default_rng(777)
    g = params.grid_size
    mask = rng.random(g) < 0.85
    r = rng.uniform(2, 100, g).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, g).astype(np.float32)
    is_ground = rng.random(g) < 0.5
    z = np.where(is_ground, rng.uniform(-2.1, -1.7, g), rng.uniform(-1, 6, g)).astype(np.float32)
    xyz = np.where(mask[:, None], np.stack([r * np.cos(az), r * np.sin(az), z], 1),
                   0.0).astype(np.float32)
    slot = np.arange(g)
    cloud = make_cloud(
        xyz,
        intensity=(np.maximum(rng.random(g), 1e-3) * mask).astype(np.float32),
        row=(slot // params.horizon_scan * mask).astype(np.int32),
        col=(slot % params.horizon_scan * mask).astype(np.int32),
        label=np.where(mask, -2, 0).astype(np.int32),
        device="cpu",
    )
    assert ordering.is_grid_ordered(cloud, params)
    labeled, multi, single = preprocess.preprocess_cloud(cloud, params, assume_ordered=True)
    want = _golden()
    assert _sha(labeled.label.numpy().astype(np.int16).tobytes()) == want["hdl64e_labels"]
    assert _sha(multi.numpy().tobytes()) == want["hdl64e_multi_bev"]
    assert _sha(single.numpy().tobytes()) == want["hdl64e_single_bev"]


def test_slope_fma_form_matches_xla():
    """pctpu's ``jnp.sqrt(dx*dx + dy*dy)`` compiles on XLA's CPU backend to
    a correctly rounded sqrt(fma(dx, dx, dy·dy)); the port computes exactly
    that, bit for bit."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    n = 200_000
    dx = (rng.standard_normal(n) * rng.choice([0.01, 1, 30], n)).astype(np.float32)
    dy = (rng.standard_normal(n) * rng.choice([0.01, 1, 30], n)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: jnp.sqrt(a * a + b * b))(dx, dy))
    got = ground._horizontal_length(torch.from_numpy(dx), torch.from_numpy(dy)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
