"""The whole reference workflow through pctpu_torch's CLIs (``--device=cpu``)
on one geometrically consistent ray-cast drive with known truth: the port's
copies of the three ``slow`` cases of ``tests/test_full_toolchain_scenario.py``.

The drive (``tests/fixtures.make_mulran_raycast_world`` and
``make_oxford_raycast_world``) goes through the port's selector,
``batch_multi_bev_gen`` and ``batch_top_part_registration`` CLIs and, on a
second copy, through pctpu's pipelines.  Every written tree must be
byte-equal to pctpu's, the registration reports within the D5 class's
windows of pctpu's (``test_torch_registration_e2e``: Δxy 1e-4 m, Δyaw 1e-3°,
fine transforms 1e-4, the same classification), and every stage is held to
the scenario's truth as pctpu's test holds pctpu: poses on the true ego poses, ground marking firing
on the flat ground and sparing the walls, registrations of overlapping
pairs inside the 0.5° window and a low-overlap pair classified failed."""

import contextlib
import io
import math
import os
import shutil

import numpy as np
import pytest
import torch

from .fixtures import make_mulran_raycast_world, make_oxford_raycast_world
from .native_oracle import available as native_available
from .native_oracle import float_bev as native_float_bev


def _pose_mat(x, y, yaw):
    m = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    m[0, 3], m[1, 3] = x, y
    return m


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _port_cli(module, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue()


def _register(root, tree, pairs, gt, entries, monkeypatch):
    """The match list of ``pairs`` (guesses 2° off the truth) through the
    port's registration CLI; returns the port's pair reports."""
    from pctpu_torch.cli import batch_top_part_registration as top_cli

    def rel(qk, mk):
        pq = _pose_mat(*gt["poses"][entries[qk][0]])
        pm = _pose_mat(*gt["poses"][entries[mk][0]])
        return np.linalg.inv(pm) @ pq

    match_file = os.path.join(root, "match_result.txt")
    with open(match_file, "w") as f:
        for qk, mk in pairs:
            t_gt = rel(qk, mk)
            f.write(f"{qk} {mk} {math.degrees(math.atan2(t_gt[1, 0], t_gt[0, 0])) + 2.0:.3f}\n")
    got = []
    real = top_cli.run_batch_top_part_registration
    monkeypatch.setattr(top_cli, "run_batch_top_part_registration",
                        lambda *a, **k: got.append(real(*a, **k)) or got[-1])
    _port_cli(top_cli, [match_file, os.path.join(tree, "non_ground_point_cloud"),
                        f"--report={os.path.join(root, 'icp_precision_report.txt')}",
                        "--flat-cap=4096", "--device=cpu"])
    return got[0], rel, match_file


def _within_truth(reports, pairs, rel):
    for (qk, mk), rep in zip(pairs, reports):
        assert rep.success, f"pair {qk}->{mk}: fitness {rep.fitness_fine}"
        t_gt = rel(qk, mk)
        tf = rep.transform_fine
        yaw_err = abs((math.degrees(math.atan2(tf[1, 0], tf[0, 0])
                                    - math.atan2(t_gt[1, 0], t_gt[0, 0])) + 180.0) % 360.0
                      - 180.0)
        t_err = float(np.hypot(tf[0, 3] - t_gt[0, 3], tf[1, 3] - t_gt[1, 3]))
        assert yaw_err < 0.5, f"pair {qk}->{mk}: yaw error {yaw_err}°"
        assert t_err < 0.30, f"pair {qk}->{mk}: translation error {t_err} m"


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    base = tmp_path_factory.mktemp("drive")
    root, jroot = str(base / "port"), str(base / "pctpu")
    gt = make_mulran_raycast_world(root, num_frames=5)
    shutil.copytree(root, jroot)
    return root, jroot, gt


@pytest.mark.slow
def test_full_toolchain_scenario(scenario, monkeypatch):
    root, jroot, gt = scenario
    from pctpu.pipelines.multi_bev import run_multi_bev as jrun_multi_bev
    from pctpu.pipelines.registration import run_batch_top_part_registration as jrun_reg
    from pctpu.pipelines.selectors import run_mulran_select as jselect
    from pctpu_torch.cli import batch_multi_bev_gen, mulran_point_cloud_select
    from pctpu_torch.io.pcd import read_pcd
    from pctpu_torch.io.poses import read_keyframe_poses

    # selection: frame 0 sits on the origin sentinel, the rest pass the gate
    _port_cli(mulran_point_cloud_select, [root, "2.0"])
    assert jselect(jroot, 2.0) == 4
    tree = os.path.join(root, "selected_keyframes_2.00m")
    jtree = os.path.join(jroot, "selected_keyframes_2.00m")
    entries = read_keyframe_poses(os.path.join(tree, "keyframe_pose.csv"))
    assert [src for src, _ in entries] == [1, 2, 3, 4]
    for src, pose in entries:
        tx, ty, tyaw = gt["poses"][src]
        assert abs(pose.x - tx) < 1e-4 and abs(pose.y - ty) < 1e-4
        assert abs(pose.yaw - tyaw) < 1e-5

    # BEV generation: ground marking fires on real geometry
    _port_cli(batch_multi_bev_gen, [tree, "OS1_64", "--batch-size=2", "--no-pngs",
                                    "--device=cpu"])
    assert jrun_multi_bev(jtree, "OS1_64", batch_size=2, write_pngs=False).num_clouds == 4
    assert _files(tree) == _files(jtree)
    ng, _ = read_pcd(os.path.join(tree, "non_ground_point_cloud", "000000.pcd"))
    lab = ng["label"].astype(np.int32)
    real = ng["intensity"] > 0.05
    assert int(((lab == 0) & real).sum()) > 3000, "ground marking barely fired"
    assert int(((lab != 0) & real).sum()) > 1500, "walls were swallowed as ground"
    with open(os.path.join(tree, "output_multi_bev", "binary", "000000.bin"), "rb") as f:
        multi = np.frombuffer(f.read(), np.uint8).reshape(24, 224, 224)
    assert int((multi > 0).sum()) > 100
    with open(os.path.join(tree, "keyframe_label.csv")) as f:
        rows = f.read().strip().split("\n")
    assert len(rows) == 4
    for row in rows:
        assert abs(sum(float(v) for v in row.split(",") if v) - 1.0) < 1e-5

    # registration against the truth; the reversed pair does not overlap
    pairs = [(2, 0), (3, 1), (0, 2)]
    reports, rel, match_file = _register(root, tree, pairs, gt, entries, monkeypatch)
    assert len(reports) == 3
    _within_truth(reports[:2], pairs[:2], rel)
    assert not reports[2].success and reports[2].fitness_fine > 1.5
    jreport = os.path.join(jroot, "icp_precision_report.txt")
    jreports = jrun_reg(match_file, os.path.join(jtree, "non_ground_point_cloud"),
                        report_path=jreport, flat_cap=4096)
    # the D5 class (``test_torch_registration_e2e``'s windows): the stacks
    # sum the normals' moments and the ICP's products in other orders
    with open(os.path.join(root, "icp_precision_report.txt")) as a, open(jreport) as b:
        ours, theirs = a.read().strip().split("\n"), b.read().strip().split("\n")
    assert len(ours) == len(theirs) == 2
    for line, jline in zip(ours, theirs):
        (dxy, dyaw), (jdxy, jdyaw) = (map(float, x.split()) for x in (line, jline))
        assert abs(dxy - jdxy) < 1e-4 and abs(dyaw - jdyaw) < 1e-3
    # the failed pair's transform is compared by its class alone (D19: a
    # low-overlap pair's fine basin is not comparable across stacks)
    assert [r.success for r in reports] == [r.success for r in jreports]
    for rep, jrep in zip(reports[:2], jreports[:2]):
        np.testing.assert_allclose(rep.transform_fine, jrep.transform_fine, rtol=0, atol=1e-4)


@pytest.mark.slow
def test_oxford_toolchain_scenario(tmp_path_factory, monkeypatch):
    """The Oxford ingest path (the transposed upside-down .bin layout,
    elevation-derived rows, the header-swapped yaw token), held jointly by
    registrations against the truth."""
    from pctpu.pipelines.multi_bev import run_multi_bev as jrun_multi_bev
    from pctpu.pipelines.selectors import run_oxford_select as jselect
    from pctpu_torch.cli import batch_multi_bev_gen, oxford_point_cloud_select
    from pctpu_torch.io.pcd import read_pcd
    from pctpu_torch.io.poses import read_keyframe_poses

    base = tmp_path_factory.mktemp("oxdrive")
    root, jroot = str(base / "port"), str(base / "pctpu")
    gt = make_oxford_raycast_world(root, num_frames=5)
    shutil.copytree(root, jroot)
    _port_cli(oxford_point_cloud_select, [root, "2.0"])
    assert jselect(jroot, 2.0) == 5
    tree = os.path.join(root, "selected_keyframes_2.00m")
    jtree = os.path.join(jroot, "selected_keyframes_2.00m")
    assert _files(tree) == _files(jtree)
    entries = read_keyframe_poses(os.path.join(tree, "keyframe_pose.csv"))
    assert [src for src, _ in entries] == [0, 1, 2, 3, 4]
    for src, pose in entries:
        tx, ty, tyaw = gt["poses"][src]
        assert abs(pose.x - tx) < 0.08 and abs(pose.y - ty) < 0.08
        assert abs(pose.yaw - tyaw) < 1e-5

    _port_cli(batch_multi_bev_gen, [tree, "HDL_32E", "--batch-size=2", "--no-pngs",
                                    "--device=cpu"])
    assert jrun_multi_bev(jtree, "HDL_32E", batch_size=2, write_pngs=False).num_clouds == 5
    assert _files(tree) == _files(jtree)
    ng, _ = read_pcd(os.path.join(tree, "non_ground_point_cloud", "000000.pcd"))
    lab = ng["label"].astype(np.int32)
    real = ng["intensity"] > 0.05
    assert int(((lab == 0) & real).sum()) > 1500
    assert int(((lab != 0) & real).sum()) > 800

    pairs = [(2, 0), (3, 1)]
    reports, rel, _ = _register(root, tree, pairs, gt, entries, monkeypatch)
    _within_truth(reports, pairs, rel)


@pytest.mark.slow
def test_scenario_manip_and_pca_tools(scenario, tmp_path):
    """cloud_manip (its float BEVs against the native oracle and pctpu's
    files) and the 3-D PCA demo's filter on the drive's geometry, against
    pctpu's."""
    root, _, _ = scenario
    src_pcd = os.path.join(root, "selected_keyframes_2.00m", "non_ground_point_cloud",
                           "000000.pcd")
    if not os.path.exists(src_pcd):  # a run of this case alone
        pytest.skip("the scenario's BEV stage has not run")
    from pctpu.io.pcd import load_cloud_pcd as jload
    from pctpu.ops.pca import pca3d as jpca3d
    from pctpu.ops.pca import pca_test_filter as jfilter
    from pctpu.pipelines.cloud_manip import run_cloud_manip as jmanip
    from pctpu_torch.cli import cloud_manip
    from pctpu_torch.io.pcd import load_cloud_pcd, read_pcd
    from pctpu_torch.ops.pca import pca3d, pca_test_filter

    ours, theirs = tmp_path / "port", tmp_path / "pctpu"
    ours.mkdir()
    theirs.mkdir()
    _port_cli(cloud_manip, [src_pcd, "1.5", "-2.0", "0.0", "10.0", f"--output_dir={ours}",
                            "--device=cpu"])
    out = jmanip(src_pcd, 1.5, -2.0, 0.0, 10.0, output_dir=str(theirs))
    assert _files(str(ours)) == _files(str(theirs))
    assert any(w.endswith("_output.csv") for w in os.listdir(ours))
    assert not np.array_equal(out["input"], out["output"])
    if native_available():
        data, _ = read_pcd(src_pcd)
        xyz = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
        np.testing.assert_array_equal(
            out["input"], native_float_bev(xyz, data["label"].astype(np.int32), False))

    # the demo keeps label > 0: relabel non-ground points 1, as pctpu's case
    cloud = load_cloud_pcd(src_pcd, 65536, device="cpu")
    cloud = cloud.replace(label=torch.where(cloud.label == -2, 1, 0).to(torch.int32))
    xyz, keep = pca_test_filter(cloud)
    assert int(keep.sum()) > 50
    mean, evals, _ = pca3d(xyz, keep)
    evals = np.asarray(evals)
    assert np.all(np.isfinite(np.asarray(mean)))
    assert 0 <= evals[0] <= evals[1] <= evals[2]
    jcloud = jload(src_pcd, 65536)
    jcloud = jcloud.replace(label=np.where(np.asarray(jcloud.label) == -2, 1, 0).astype(np.int32))
    jxyz, jkeep = jfilter(jcloud)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    jmean, jevals, _ = jpca3d(jxyz, jkeep)
    np.testing.assert_array_equal(np.asarray(mean).view(np.uint32),
                                  np.asarray(jmean).view(np.uint32))
    np.testing.assert_array_equal(evals.view(np.uint32), np.asarray(jevals).view(np.uint32))
