"""The dataset selectors, readers, SE(3) helpers and keyframe gate of
pctpu_torch against pctpu's, on the CPU.

Each case of ``tests/test_selectors_e2e.py`` runs through both packages on
two copies of one fixture tree: the output trees must be byte-identical,
file by file, and the logs and keyframe counts equal.  The readers
(``tests/test_io_readers.py:50-156``), the SE(3) helpers
(``tests/test_geom.py``) and the greedy gate (``tests/test_select.py:12-22``)
must return equal arrays (bit for bit) on the same inputs.  The selectors
are host numpy in both packages: no tolerance anywhere."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from pctpu.geom import se3 as jse3
from pctpu.io import kitti as jkitti
from pctpu.io import mulran as jmulran
from pctpu.io import oxford as joxford
from pctpu.io import poses as jposes
from pctpu.ops import select as jselect
from pctpu.pipelines import selectors as jsel
from pctpu_torch.geom import se3 as tse3
from pctpu_torch.io import kitti as tkitti
from pctpu_torch.io import mulran as tmulran
from pctpu_torch.io import oxford as toxford
from pctpu_torch.io import poses as tposes
from pctpu_torch.ops import select as tselect
from pctpu_torch.pipelines import selectors as tsel

from .fixtures import (make_kitti_raw_tree, make_kitti_tree, make_mulran_tree,
                       make_oxford_tree, synth_kitti_scan)
from .ref_impl import kitti_raw_structured_ref


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _drop_bin(sub: str, index: int):
    def mutate(root):
        d = os.path.join(root, sub)
        os.remove(os.path.join(d, sorted(os.listdir(d))[index]))
    return mutate


def _orphan_stamp(root):
    orphan = 9_000_000_000  # far beyond the last GT stamp
    with open(os.path.join(root, "sensor_data", "ouster_front_stamp.csv"), "a") as f:
        f.write(f"{orphan}\n")
    np.zeros(4096 * 4, np.float32).tofile(
        os.path.join(root, "sensor_data", "Ouster", f"{orphan:010d}.bin"))


# (fixture, its arguments, selector, selector arguments, tree mutation, output dir)
CASES = {
    "kitti_e2e": (make_kitti_tree, dict(num_frames=6, spacing=3.0), "run_kitti_select",
                  dict(interval=2.0), None, "selected_keyframes_2.00m"),
    "kitti_large_interval": (make_kitti_tree, dict(num_frames=5, spacing=3.0),
                             "run_kitti_select", dict(interval=100.0), None,
                             "selected_keyframes_100.00m"),
    "mulran_e2e": (make_mulran_tree, dict(num_frames=5, spacing_m=3.0), "run_mulran_select",
                   dict(interval=2.0), None, "selected_keyframes_2.00m"),
    "mulran_missing_cloud": (make_mulran_tree, dict(num_frames=3, spacing_m=3.0),
                             "run_mulran_select", dict(interval=2.0),
                             _drop_bin("sensor_data/Ouster", 1), "selected_keyframes_2.00m"),
    "mulran_stamp_outside_gt": (make_mulran_tree, dict(num_frames=5), "run_mulran_select",
                                dict(interval=2.0), _orphan_stamp,
                                "selected_keyframes_2.00m"),
    "oxford_e2e": (make_oxford_tree, dict(num_frames=5, spacing_m=3.0), "run_oxford_select",
                   dict(interval=2.0), None, "selected_keyframes_2.00m"),
    "oxford_negative_yaw": (make_oxford_tree,
                            dict(num_frames=4, spacing_m=3.0, rpy_cols=(-0.8, 0.02, 0.01)),
                            "run_oxford_select", dict(interval=2.0), None,
                            "selected_keyframes_2.00m"),
    "oxford_missing_cloud": (make_oxford_tree, dict(num_frames=5), "run_oxford_select",
                             dict(interval=2.0), _drop_bin("velodyne_left", 2),
                             "selected_keyframes_2.00m"),
    "kitti_raw_e2e": (make_kitti_raw_tree, dict(num_frames=5, spacing=3.0),
                      "run_kitti_raw_select", {}, None, "selected_keyframes"),
    "kitti_raw_missing_bin": (make_kitti_raw_tree, dict(num_frames=4), "run_kitti_raw_select",
                              {}, _drop_bin("velodyne", 2), "selected_keyframes"),
}


def _run(module, name, root, kwargs):
    """(keyframes, stdout, stderr) of one selector run, the tree's path in
    the logs replaced by ``ROOT``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        n = getattr(module, name)(root, **kwargs)
    return n, out.getvalue().replace(root, "ROOT"), err.getvalue().replace(root, "ROOT")


@pytest.mark.parametrize("case", sorted(CASES))
def test_selector_trees_match_pctpu(tmp_path, case):
    make, make_kw, runner, run_kw, mutate, sub = CASES[case]
    base = str(tmp_path / "pctpu")
    make(base, **make_kw)
    if mutate is not None:
        mutate(base)
    port = str(tmp_path / "port")
    shutil.copytree(base, port)
    want = _run(jsel, runner, base, run_kw)
    got = _run(tsel, runner, port, run_kw)
    assert got == want
    want_files, got_files = _files(os.path.join(base, sub)), _files(os.path.join(port, sub))
    assert sorted(got_files) == sorted(want_files)
    assert [k for k in want_files if got_files[k] != want_files[k]] == []
    # no tensor reached any device: the selectors never initialise CUDA
    assert not torch.cuda.is_initialized()


def test_selector_resume_matches_pctpu(tmp_path):
    """--resume keeps existing keyframe PCDs and rewrites the pose CSV, in
    both packages alike."""
    for pkg, name in ((jsel, "pctpu"), (tsel, "port")):
        root = str(tmp_path / name)
        make_kitti_tree(root, num_frames=5, spacing=3.0)
        _run(pkg, "run_kitti_select", root, dict(interval=2.0))
        marker = os.path.join(root, "selected_keyframes_2.00m", "keyframe_point_cloud",
                              "000000.pcd")
        before = os.path.getmtime(marker)
        _run(pkg, "run_kitti_select", root, dict(interval=2.0, resume=True))
        assert os.path.getmtime(marker) == before
    assert (_files(str(tmp_path / "pctpu" / "selected_keyframes_2.00m"))
            == _files(str(tmp_path / "port" / "selected_keyframes_2.00m")))


def test_kitti_pose_count_mismatch_raises(tmp_path):
    root = str(tmp_path)
    make_kitti_tree(root, num_frames=4)
    times = os.path.join(root, "times.txt")
    lines = open(times).read().strip().split("\n")
    open(times, "w").write("\n".join(lines[:-1]) + "\n")
    for pkg in (jsel, tsel):
        with pytest.raises(ValueError, match="do NOT agree"):
            _run(pkg, "run_kitti_select", root, dict(interval=2.0))


@pytest.mark.parametrize("tool,make,args", [
    ("kitti_point_cloud_select", make_kitti_tree, ["2.5"]),
    ("kitti_raw_point_cloud_select", make_kitti_raw_tree, []),
    ("mulran_point_cloud_select", make_mulran_tree, ["2"]),
    ("oxford_point_cloud_select", make_oxford_tree, []),
])
def test_selector_clis_match_pctpu(tmp_path, tool, make, args):
    """The CLIs take pctpu's argv (no --device) and write the same trees
    and logs."""
    import importlib

    base = str(tmp_path / "pctpu")
    make(base)
    port = str(tmp_path / "port")
    shutil.copytree(base, port)
    logs = []
    for pkg, root in (("pctpu", base), ("pctpu_torch", port)):
        main = importlib.import_module(f"{pkg}.cli.{tool}").main
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            assert main([root, *args]) == 0
        logs.append(out.getvalue().replace(root, "ROOT"))
    assert logs[0] == logs[1]
    assert _files(base) == _files(port)


def test_kitti_raw_structuring_matches_oracle():
    """The raw structuring on the scans of pctpu's oracle test: the port,
    pctpu and the loop transcription agree array for array."""
    rng = np.random.default_rng(11)
    neg = synth_kitti_scan(rng)
    neg[0, :2] = [1.0, -0.5]
    scans = [synth_kitti_scan(rng), rng.normal(0, 20, (4000, 4)).astype(np.float32),
             synth_kitti_scan(rng, rings=70, per_ring=40), np.zeros((0, 4), np.float32), neg]
    for scan in scans:
        got = tkitti.structure_cloud(scan, rings=tkitti.assign_rings_raw(scan))
        want = kitti_raw_structured_ref(scan)
        pctpu_out = jkitti.structure_cloud(scan, rings=jkitti.assign_rings_raw(scan))
        assert set(got) == set(want) == set(pctpu_out)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], pctpu_out[k], err_msg=k)


def _equal(a, b) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed,rings", [(0, 4), (1, 3), (2, 2), (5, 6)])
def test_kitti_readers_match_pctpu(seed, rings, tmp_path):
    """assign_rings, structure_cloud (the intensity −1 quirk and
    keep_intensity), read_bin, and point 0 never assigned."""
    scan = synth_kitti_scan(np.random.default_rng(seed), rings=rings, per_ring=1300)
    _equal(tkitti.assign_rings(scan), jkitti.assign_rings(scan))
    assert not tkitti.assign_rings(scan)[2][0]
    for keep in (False, True):
        _equal(tkitti.structure_cloud(scan, keep_intensity=keep),
               jkitti.structure_cloud(scan, keep_intensity=keep))
    path = str(tmp_path / "scan.bin")
    scan.tofile(path)
    _equal(tkitti.read_bin(path), jkitti.read_bin(path))
    _equal(tkitti.read_bin(path, tkitti.RAW_MAX_NUM_POINTS),
           jkitti.read_bin(path, jkitti.RAW_MAX_NUM_POINTS))


@pytest.mark.parametrize("seed", [3, 13])
def test_mulran_and_oxford_readers_match_pctpu(seed, tmp_path):
    rng = np.random.default_rng(seed)
    n = 2000
    pts = np.stack([rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
                    rng.uniform(-3, 10, n), rng.random(n)], 1).astype(np.float32)
    path = str(tmp_path / "cloud.bin")
    pts.tofile(path)
    _equal(tmulran.read_bin(path), jmulran.read_bin(path))
    np.testing.assert_array_equal(tmulran.read_bin(path)["row"], np.arange(n) % 64)
    # the Oxford layout: all x, then y, z and intensity
    np.concatenate([pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]]).tofile(path)
    got = toxford.read_bin(path)
    _equal(got, joxford.read_bin(path))
    np.testing.assert_array_equal(got["x"], -pts[:, 0])
    assert got["row"].max() <= 31 and got["col"].max() < 1056


def test_pose_files_match_pctpu(tmp_path, capsys):
    """MulRan's global_pose.csv (sorted by stamp), Oxford's ins.csv, the
    KITTI pose readers, and the keyframe pose reader stopping at a short
    row with the reference's message."""
    mp = str(tmp_path / "global_pose.csv")
    open(mp, "w").write("200,1,0,0,5.0,0,1,0,6.0,0,0,1,7.0\n"
                        "100,1,0,0,1.0,0,1,0,2.0,0,0,1,3.0\n")
    _equal(tmulran.read_global_poses(mp), jmulran.read_global_poses(mp))
    stamps = tmp_path / "stamps.csv"
    stamps.write_text("30\n10,x\n20\n")
    _equal(tmulran.read_timestamps(str(stamps)), jmulran.read_timestamps(str(stamps)))

    make_oxford_tree(str(tmp_path / "ox"), num_frames=3, rpy_cols=(-0.8, 0.02, 0.01))
    ins = str(tmp_path / "ox" / "gps" / "ins.csv")
    _equal(toxford.read_ins_poses(ins), joxford.read_ins_poses(ins))

    make_kitti_tree(str(tmp_path / "k"), num_frames=3)
    gp = str(tmp_path / "k" / "global_pose.txt")
    _equal(tkitti.read_global_poses(gp), jkitti.read_global_poses(gp))
    _equal(tkitti.read_raw_gt_poses(gp), jkitti.read_raw_gt_poses(gp))
    times = str(tmp_path / "k" / "times.txt")
    assert tkitti.read_timestamps(times) == jkitti.read_timestamps(times)

    p = tmp_path / "keyframe_pose.csv"
    good = "000000,1.0,2.0,3.0,0,0,0,1.0,0.0,0.0,0.0,1.0,0.0,0.0,0.0,1.0\n"
    p.write_text(good + "000001,1.0,2.0\n" + good)
    entries = tposes.read_keyframe_poses(str(p))
    assert len(entries) == 1
    assert "while expecting 16" in capsys.readouterr().err
    want = jposes.read_keyframe_poses(str(p))[0][1]
    got = entries[0][1]
    for field in ("x", "y", "z", "roll", "pitch", "yaw", "rotation_matrix", "rotation_quat"):
        _equal(getattr(got, field), getattr(want, field))


def _rotations(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    mats = [jse3.euler_zyx_to_matrix(*rng.uniform(-np.pi, np.pi, 3)) for _ in range(n)]
    mats.append(jse3.euler_zyx_to_matrix(0.3, np.pi / 2, -0.2))  # singular branch
    mats.append(jse3.euler_zyx_to_matrix(0.0, 0.0, -0.8))  # negative yaw
    return mats


@pytest.mark.parametrize("fn", ["is_rotation_matrix", "rotation_matrix_to_euler_angles",
                                "eigen_euler_angles_xyz", "eigen_euler_angles_zyx",
                                "quat_from_matrix"])
def test_rotation_helpers_match_pctpu(fn):
    for r in _rotations(40, 1):
        _equal(getattr(tse3, fn)(r), getattr(jse3, fn)(r))
    assert not tse3.is_rotation_matrix(np.diag([1.0, 1.0, 1.1]))


def test_quaternions_and_interpolation_match_pctpu():
    rng = np.random.default_rng(2)
    mats = _rotations(20, 3)
    for a, b in zip(mats, mats[1:]):
        qa, qb = tse3.quat_from_matrix(a), tse3.quat_from_matrix(b)
        _equal(tse3.quat_to_matrix(qa), jse3.quat_to_matrix(qa))
        for t in (0.0, 0.25, 0.5, 1.0):
            _equal(tse3.quat_slerp(qa, qb, t), jse3.quat_slerp(qa, qb, t))
            _equal(tse3.quat_slerp(qa, -qb, t), jse3.quat_slerp(qa, -qb, t))
        ta, tb = rng.uniform(-100, 100, 3), rng.uniform(-100, 100, 3)
        pa, pb = tse3.Pose6f.from_matrix(a, ta), tse3.Pose6f.from_matrix(b, tb)
        ja, jb = jse3.Pose6f.from_matrix(a, ta), jse3.Pose6f.from_matrix(b, tb)
        _equal(vars(pa), vars(ja))
        _equal(tse3.pose_distance(pa, pb), jse3.pose_distance(ja, jb))
        for euler in ("utility", "eigen_zyx"):
            ratio = float(rng.random())
            _equal(vars(tse3.interpolate_pose(pa, pb, ratio, euler=euler)),
                   vars(jse3.interpolate_pose(ja, jb, ratio, euler=euler)))
        _equal(tse3.euler_zyx_to_matrix(*ta / 100), jse3.euler_zyx_to_matrix(*ta / 100))
        _equal(tse3.yaw_rotation_4x4(ta[0]), jse3.yaw_rotation_4x4(ta[0]))
        _equal(tposes.format_pose_entry(7, pa), jposes.format_pose_entry(7, ja))
    with pytest.raises(ValueError):
        tse3.interpolate_pose(pa, pb, 0.5, euler="xyz")


def test_pose_format_file_matches_pctpu(tmp_path):
    tposes.write_pose_format_file(str(tmp_path / "a.csv"))
    jposes.write_pose_format_file(str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


@pytest.mark.parametrize("spacing,interval,sentinel", [
    (0.5, 2.0, (-1e10, -1e10, 0.0)), (3.0, 2.0, (-1e10, -1e10, 0.0)),
    (1.0, 2.0, (0.0, 0.0, 0.0)), (0.7, 1.4, (0.0, 0.0, 0.0))])
def test_greedy_keyframe_mask_matches_pctpu(spacing, interval, sentinel):
    pos = np.zeros((12, 3), np.float32)
    pos[:, 0] = np.arange(12) * spacing
    pos[:, 1] = np.sin(np.arange(12)) * 0.3
    keep = tselect.greedy_keyframe_mask(pos, interval, sentinel=sentinel)
    np.testing.assert_array_equal(keep, jselect.greedy_keyframe_mask(pos, interval,
                                                                     sentinel=sentinel))
    if spacing == 0.5:
        np.testing.assert_array_equal(keep[:5], [True, False, False, False, True])


def test_rounding_numpy_helpers_match_pctpu():
    from pctpu.ops import rounding as jr
    from pctpu_torch.ops import rounding as tr

    v = np.concatenate([np.arange(-40, 41) * 0.25, np.random.default_rng(0).normal(0, 50, 500)])
    _equal(tr.c_round_np(v), jr.c_round_np(v))
    for coord in (v.astype(np.float32), np.float32(-0.5), np.float32(99.9)):
        _equal(tr.bev_cell_np(coord, 100.0, 0.5), jr.bev_cell_np(coord, 100.0, 0.5))


def test_mulran_select_into_multi_bev(tmp_path):
    """The user flow of pctpu's test_mulran_to_multibev_integration through
    the port alone (pctpu's is a slow test): a ground-heavy MulRan tree →
    the selector → batch_multi_bev_gen (OS1_64) on the CPU; ground marking
    fires, and the selector's tree equals pctpu's."""
    from pctpu_torch.pipelines.multi_bev import run_multi_bev

    root = str(tmp_path / "mulran")
    make_mulran_tree(root, num_frames=3, spacing_m=3.0)
    rng = np.random.default_rng(7)
    bin_dir = os.path.join(root, "sensor_data", "Ouster")
    for name in os.listdir(bin_dir):
        n = 4096
        r, az = rng.uniform(3, 35, n), rng.uniform(0, 2 * np.pi, n)
        ground = rng.random(n) < 0.7
        z = np.where(ground, -1.9 + rng.normal(0, 0.01, n), rng.uniform(0, 6, n))
        np.stack([r * np.cos(az), r * np.sin(az), z, rng.uniform(0.1, 1.0, n)],
                 1).astype(np.float32).tofile(os.path.join(bin_dir, name))
    other = str(tmp_path / "pctpu")
    shutil.copytree(root, other)
    assert _run(tsel, "run_mulran_select", root, dict(interval=2.0))[0] == 3
    _run(jsel, "run_mulran_select", other, dict(interval=2.0))
    tree = os.path.join(root, "selected_keyframes_2.00m")
    assert _files(tree) == _files(os.path.join(other, "selected_keyframes_2.00m"))
    # one intra-op thread: the pipeline's loader, writer and main threads each
    # drive torch ops, and a pool per thread beside another worker's stalls both
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = run_multi_bev(tree, "OS1_64", batch_size=2, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert out.num_clouds == 3
    from pctpu_torch.io.pcd import read_pcd

    data, meta = read_pcd(os.path.join(tree, "non_ground_point_cloud", "000000.pcd"))
    assert meta["points"] == 64 * 1024
    assert int((data["label"] == 0).sum()) > 1000
    assert int((data["label"] == -2).sum()) > 100
