"""pctpu's adversarial real-log shapes (``tests/test_adversarial_shapes.py``,
VERDICT r3 item 4) through the port on the CPU: clouds over the grid's
capacity (the host last-wins compaction), dropped azimuth sectors,
duplicate and shuffled GT stamps, all-ground and no-ground scenes and a
vanished KITTI bin.  Each asserts the reference's semantics for the shape,
as pctpu's does, and where both packages write a tree, the port's equals
pctpu's."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from pctpu.ops.ordering import compact_last_wins as jcompact
from pctpu_torch.cloud import make_cloud
from pctpu_torch.config import SensorParams
from pctpu_torch.ops.ordering import compact_last_wins, get_ordered_cloud

from .fixtures import make_mulran_raycast_world
from .ref_impl import ordered_cloud_ref
from .test_adversarial_shapes import TINY as JTINY
from .test_adversarial_shapes import _pcd_fields

TINY = SensorParams(n_scan=8, horizon_scan=48, ground_upper_scan=4, height_res=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def test_compact_last_wins_matches_loop_oracle():
    """Host compaction + the port's ordering reproduce getOrderedCloud
    (reference/BatchMultiBevGen.cpp:94-117) on a cloud LARGER than the
    grid, duplicate cells whose winner comes after the capacity cut
    included; the compaction equals pctpu's."""
    rng = np.random.default_rng(3)
    g = TINY.grid_size
    n = g + 200
    rows = rng.integers(-1, TINY.n_scan + 1, n)
    cols = rng.integers(-2, TINY.horizon_scan + 2, n)
    xyz = rng.normal(0, 10, (n, 3)).astype(np.float32)
    fields = _pcd_fields(xyz, intensity=rng.random(n), row=np.maximum(rows, 0),
                         col=np.maximum(cols, 0), label=rng.integers(-2, 1, n))
    fields["row"] = rows.astype(np.int32)
    fields["col"] = cols.astype(np.int32)

    compacted, n_keep = compact_last_wins(fields, n, TINY)
    jcompacted, jn_keep = jcompact(fields, n, JTINY)
    assert n_keep == jn_keep <= g
    for k in fields:
        np.testing.assert_array_equal(compacted[k], jcompacted[k], err_msg=k)

    cloud = make_cloud(np.stack([compacted["x"], compacted["y"], compacted["z"]], 1),
                       intensity=compacted["intensity"], row=compacted["row"],
                       col=compacted["col"], t=compacted["t"], label=compacted["label"],
                       capacity=g, device="cpu")
    ordered = get_ordered_cloud(cloud, TINY)
    pts = [{"x": float(xyz[i, 0]), "y": float(xyz[i, 1]), "z": float(xyz[i, 2]),
            "intensity": float(fields["intensity"][i]), "row": int(rows[i]),
            "col": int(cols[i]), "t": int(fields["t"][i]), "label": int(fields["label"][i])}
           for i in range(n)]
    ref = ordered_cloud_ref(pts, TINY.n_scan, TINY.horizon_scan)
    np.testing.assert_array_equal(ordered.xyz.numpy(),
                                  np.array([[p["x"], p["y"], p["z"]] for p in ref], np.float32))
    np.testing.assert_array_equal(ordered.t.numpy(), np.array([p["t"] for p in ref], np.int64))
    np.testing.assert_array_equal(ordered.label.numpy(), np.array([p["label"] for p in ref]))


@pytest.mark.slow
def test_multi_bev_over_capacity_cloud_last_wins(tmp_path):
    """``run_multi_bev`` on a PCD with more points than the grid: the late
    duplicate-cell winner (input index past the capacity) lands in the
    output, as the reference's unbounded loop places it."""
    from pctpu_torch.io.pcd import read_pcd, write_pcd
    from pctpu_torch.pipelines.multi_bev import run_multi_bev

    g = TINY.grid_size
    rng = np.random.default_rng(4)
    n = g + 64
    rows = rng.integers(0, TINY.n_scan, n)
    cols = rng.integers(0, TINY.horizon_scan, n)
    rows[-1], cols[-1] = rows[0], cols[0]
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(2.0, 5.0, n)
    xyz[-1, 2] = np.float32(4.321)

    root = tmp_path / "tree"
    cloud_dir = root / "keyframe_point_cloud"
    os.makedirs(cloud_dir)
    write_pcd(str(cloud_dir / "000000.pcd"), _pcd_fields(xyz, row=rows, col=cols))
    (root / "keyframe_pose.csv").write_text(
        "000000, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0,"
        " 0.0, 0.0, 1.0\n")

    out = _quiet(run_multi_bev, str(root), TINY, batch_size=1, write_pngs=False, device="cpu")
    assert out.num_clouds == 1
    data, meta = read_pcd(str(root / "non_ground_point_cloud" / "000000.pcd"))
    assert meta["points"] == g
    slot = int(rows[0]) * TINY.horizon_scan + int(cols[0])
    assert data["z"][slot] == np.float32(4.321), "the late duplicate-cell winner was cut"


@pytest.mark.slow
def test_mulran_empty_azimuth_sector_pipeline(tmp_path):
    """Dropped packets: a contiguous azimuth sector of every frame returns
    nothing.  The port's selector and BEV pipeline run unchanged, the
    sector's cells stay all-zero with label 0, and the selector's tree
    equals pctpu's."""
    from pctpu.pipelines.selectors import run_mulran_select as jrun_mulran_select
    from pctpu_torch.io.pcd import read_pcd
    from pctpu_torch.pipelines.multi_bev import run_multi_bev
    from pctpu_torch.pipelines.selectors import run_mulran_select

    root = str(tmp_path / "drive")
    make_mulran_raycast_world(root, num_frames=3)
    bin_dir = os.path.join(root, "sensor_data", "Ouster")
    for name in os.listdir(bin_dir):
        path = os.path.join(bin_dir, name)
        scan = np.fromfile(path, np.float32).reshape(-1, 64, 4)
        scan[40:80] = 0.0
        scan.tofile(path)
    other = str(tmp_path / "pctpu")
    shutil.copytree(root, other)

    assert _quiet(run_mulran_select, root, 2.0) == 2
    _quiet(jrun_mulran_select, other, 2.0)
    tree = os.path.join(root, "selected_keyframes_2.00m")
    for rel in ("keyframe_pose.csv", "keyframe_point_cloud/000000.pcd",
                "keyframe_point_cloud/000001.pcd"):
        with open(os.path.join(tree, rel), "rb") as a, open(
                os.path.join(other, "selected_keyframes_2.00m", rel), "rb") as b:
            assert a.read() == b.read(), rel
    out = _quiet(run_multi_bev, tree, "OS1_64", batch_size=2, write_pngs=False, device="cpu")
    assert out.num_clouds == 2

    data, _ = read_pcd(os.path.join(tree, "non_ground_point_cloud", "000000.pcd"))
    cols = np.arange(1024)[None, :].repeat(64, 0).reshape(-1)
    sector = (cols >= 40) & (cols < 80)
    assert np.all(data["x"][sector] == 0.0)
    assert np.all(data["z"][sector] == 0.0)
    assert np.all(data["label"][sector] == 0)
    assert np.any(data["x"][~sector] != 0.0)


@pytest.mark.slow
def test_mulran_duplicate_gt_stamp_nan_pose_skipped(tmp_path):
    """Duplicate GT stamps give 0/0 in the reference's interpolation
    (MulranPointCloudSelect.cpp:320-346): a NaN pose.  The frame is still
    saved (``dist < interval`` is false for NaN, :348-351), and later
    frames select normally."""
    from pctpu_torch.pipelines.selectors import run_mulran_select

    root = tmp_path / "drive"
    os.makedirs(root / "sensor_data" / "Ouster")
    rows = [
        "200,1.0,0.0,0.0,0.0,0.0,1.0,0.0,0.0,0.0,0.0,1.0,0.0",
        "200,1.0,0.0,0.0,7.0,0.0,1.0,0.0,0.0,0.0,0.0,1.0,0.0",
        "300,1.0,0.0,0.0,5.0,0.0,1.0,0.0,5.0,0.0,0.0,1.0,0.0",
    ]
    (root / "global_pose.csv").write_text("\n".join(rows) + "\n")
    (root / "sensor_data" / "ouster_front_stamp.csv").write_text("200\n250\n")
    rng = np.random.default_rng(0)
    for s in (200, 250):
        rng.uniform(-10, 10, (64 * 16, 4)).astype(np.float32).tofile(
            root / "sensor_data" / "Ouster" / f"{s:010d}.bin")

    assert _quiet(run_mulran_select, str(root), 2.0) == 2
    lines = (root / "selected_keyframes_2.00m" / "keyframe_pose.csv").read_text().strip()
    lines = lines.split("\n")
    assert len(lines) == 2
    assert lines[0].startswith("000000") and "nan" in lines[0].lower()
    assert lines[1].startswith("000001") and "nan" not in lines[1].lower()


@pytest.mark.slow
def test_mulran_shuffled_gt_rows_identical_output(tmp_path):
    """GT and stamp rows are sorted by the reader
    (MulranPointCloudSelect.cpp:216-228): shuffled rows on disk give a
    byte-identical selection."""
    from pctpu_torch.pipelines.selectors import run_mulran_select

    roots = []
    for shuffle in (False, True):
        root = str(tmp_path / ("shuf" if shuffle else "sorted"))
        make_mulran_raycast_world(root, num_frames=3)
        if shuffle:
            rng = np.random.default_rng(1)
            for rel in ("global_pose.csv", os.path.join("sensor_data",
                                                        "ouster_front_stamp.csv")):
                path = os.path.join(root, rel)
                rows = open(path).read().strip().split("\n")
                rng.shuffle(rows)
                open(path, "w").write("\n".join(rows) + "\n")
        assert _quiet(run_mulran_select, root, 2.0) == 2
        roots.append(root)
    for rel in ("keyframe_pose.csv", "keyframe_point_cloud/000000.pcd",
                "keyframe_point_cloud/000001.pcd"):
        a, b = (open(os.path.join(r, "selected_keyframes_2.00m", rel), "rb").read()
                for r in roots)
        assert a == b, rel


@pytest.mark.slow
def test_zero_ground_and_all_ground_scenes():
    """A wall-only cloud marks no ground; a flat plane marks the swept band;
    both give finite BEVs (the slope test's closed form must not NaN on
    constant z columns, BatchMultiBevGen.cpp's ground slope test)."""
    from pctpu_torch.cloud import stack_clouds
    from pctpu_torch.ops.preprocess import preprocess_batch

    g = TINY.grid_size
    rows = np.arange(g) // TINY.horizon_scan
    cols = np.arange(g) % TINY.horizon_scan
    az = cols * (2 * np.pi / TINY.horizon_scan)

    def run(z):
        r = 5.0 + 0.5 * rows
        xyz = np.stack([r * np.cos(az), r * np.sin(az), z], axis=1).astype(np.float32)
        cloud = make_cloud(xyz, row=rows, col=cols, label=np.full(g, -2), capacity=g,
                           device="cpu")
        labeled, multi, single = preprocess_batch(stack_clouds([cloud]), TINY,
                                                  assume_ordered=False)
        assert torch.isfinite(labeled.xyz).all()
        assert torch.isfinite(single.float()).all()
        return labeled.label[0].numpy(), multi.numpy()

    lab_wall, multi_w = run(z=(-1.5 + 0.8 * (TINY.n_scan - 1 - rows)))
    assert int((lab_wall == 0).sum()) == 0, "the wall ring was swallowed as ground"
    assert multi_w.sum() > 0

    lab_flat, _ = run(z=np.full(g, -1.9, np.float32))
    swept = rows >= TINY.n_scan - TINY.ground_upper_scan - 1
    marked = int((lab_flat == 0).sum())
    assert marked > 0.5 * int(swept.sum()), f"flat plane: {marked} of {int(swept.sum())} marked"


@pytest.mark.slow
def test_kitti_missing_bin_raises(tmp_path):
    """A velodyne bin gone mid-sequence: the reference exits with an error
    (KittiPointCloudSelect.cpp:427-430); the port raises."""
    from pctpu_torch.pipelines.selectors import run_kitti_select

    from .fixtures import make_kitti_tree

    root = str(tmp_path / "kitti")
    make_kitti_tree(root, num_frames=3, spacing=3.0)
    os.remove(os.path.join(root, "velodyne", "000001.bin"))
    with pytest.raises(FileNotFoundError):
        _quiet(run_kitti_select, root, 2.0)
