"""The registration slice end to end: pctpu_torch's batch_top_part_registration
CLI against pctpu's pipeline on one small pair tree, on the CPU.

The tree holds three clouds of a cluster scene (capacity 1024) and four
pairs, one with a yaw near 180°.  Both packages run the short dry-run config
(``__graft_entry__.py``'s), which keeps the CPU JAX run short.  They must
classify every pair alike; report values agree within Δxy 1e-4 m and Δyaw
1e-3°, fine transforms within 1e-4 (D5 class: the two stacks sum in
different orders)."""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import pctpu.cloud as jcloud
import pctpu.io.pcd as jpcd
from pctpu.config import IcpConfig as JIcpConfig
from pctpu.config import RegistrationConfig as JRegistrationConfig
from pctpu.pipelines.registration import (
    run_batch_top_part_registration as pctpu_run,
)
from pctpu_torch import make_cloud, registration_config_from
from pctpu_torch.cli import batch_top_part_registration as port_cli
from pctpu_torch.io import pcd as tpcd
from pctpu_torch.pipelines import registration as port_reg

from .test_pcd import _lzf_compress_literals

SMALL = JRegistrationConfig(
    coarse=JIcpConfig(max_correspondence_distance=10.0, max_iterations=3,
                      point_to_plane=True),
    fine=JIcpConfig(max_correspondence_distance=1.0, max_iterations=5,
                    transformation_epsilon=1e-6, euclidean_fitness_epsilon=0.01),
)
# (yaw in degrees, translation) of each cloud relative to the base scene
POSES = [(0.0, (0.0, 0.0)), (9.0, (0.5, -0.4)), (176.0, (1.0, 0.3))]
PAIRS = [(0, 1, 9.0), (1, 0, -9.0), (0, 2, 174.0), (2, 1, -165.0)]


def _base_scene():
    """Dense building clusters + ground (``__graft_entry__.py``'s dry-run
    scene): every occupied top-part cell clears the 20-point minimum."""
    rng = np.random.default_rng(2)
    pts = [np.stack([cx + rng.normal(0, 2.0, 80), cy + rng.normal(0, 2.0, 80),
                     rng.uniform(0, 8, 80)], 1)
           for cx, cy in [(-25.0, -25.0), (25.0, -25.0), (-25.0, 25.0),
                          (25.0, 25.0), (0.0, 0.0)]]
    pts.append(np.stack([rng.uniform(-40, 40, 200), rng.uniform(-40, 40, 200),
                         rng.uniform(-2.0, -1.9, 200)], 1))
    xyz = np.concatenate(pts).astype(np.float32)
    lab = np.concatenate([np.full(400, -2), np.zeros(200)]).astype(np.int32)
    return xyz, lab


def _pose(yaw_deg, shift):
    th = math.radians(yaw_deg)
    rot = np.array([[math.cos(th), -math.sin(th), 0], [math.sin(th), math.cos(th), 0],
                    [0, 0, 1]], np.float32)
    return rot, np.float32([shift[0], shift[1], 0.0])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    clouds = root / "clouds"
    clouds.mkdir()
    xyz, lab = _base_scene()
    rng = np.random.default_rng(3)
    for k, (yaw, shift) in enumerate(POSES):
        rot, t = _pose(yaw, shift)
        moved = (xyz @ rot.T + t + rng.normal(0, 0.01, xyz.shape)).astype(np.float32)
        tpcd.save_cloud_pcd(str(clouds / f"{k:06d}.pcd"),
                            make_cloud(moved, label=lab, capacity=1024, device="cpu"))
    match = root / "match_result.txt"
    match.write_text("".join(f"{q} {m} {g}\n" for q, m, g in PAIRS))
    return root, str(match), str(clouds)


def _run_port(monkeypatch, argv, cfg):
    """The port's CLI main(), with its pipeline given ``cfg`` and its
    per-pair reports captured."""
    captured = []

    def runner(*args, **kwargs):
        captured.extend(port_reg.run_batch_top_part_registration(*args, cfg=cfg, **kwargs))
        return captured

    monkeypatch.setattr(port_cli, "run_batch_top_part_registration", runner)
    assert port_cli.main(argv) == 0
    return captured


def _parse(path):
    return [tuple(float(v) for v in line.split()) for line in open(path)]


def test_cli_matches_pctpu(tree, monkeypatch, capsys):
    root, match, clouds = tree
    ref_report = str(root / "pctpu_report.txt")
    ref = pctpu_run(match, clouds, cfg=SMALL, report_path=ref_report,
                    capacity=1024, flat_cap=1024, pair_batch=1)
    port_report = str(root / "port_report.txt")
    got = _run_port(monkeypatch,
                    [match, clouds, f"--report={port_report}", "--capacity=1024",
                     "--flat-cap=1024", "--device=cpu"],
                    registration_config_from(dataclasses.asdict(SMALL)))
    out = capsys.readouterr().out
    assert "device: cpu" in out and "[TIME] Avg Tiempo for 2nd Stage (fine)" in out

    assert [r.success for r in got] == [r.success for r in ref]
    assert sum(r.success for r in got) >= 3
    a, b = _parse(ref_report), _parse(port_report)
    assert len(a) == len(b) == sum(r.success for r in ref)
    for (xy_a, yaw_a), (xy_b, yaw_b) in zip(a, b):
        assert abs(xy_a - xy_b) <= 1e-4 and abs(yaw_a - yaw_b) <= 1e-3
    for r_ref, r_got in zip(ref, got):
        np.testing.assert_allclose(r_got.transform_fine, r_ref.transform_fine, atol=1e-4)
    # the fine transform recovers the known relative pose
    for (q, m, _), r in zip(PAIRS, got):
        if r.success:
            yaw = math.degrees(math.atan2(r.transform_fine[1, 0], r.transform_fine[0, 0]))
            true = (POSES[m][0] - POSES[q][0] + 180.0) % 360.0 - 180.0
            assert abs((yaw - true + 180.0) % 360.0 - 180.0) < 0.5


def test_cli_resume_and_unported_flags(tree, monkeypatch):
    root, match, clouds = tree
    report = str(root / "resume_report.txt")
    cfg = registration_config_from(dataclasses.asdict(SMALL))
    argv = [match, clouds, f"--report={report}", "--capacity=1024",
            "--flat-cap=1024", "--device=cpu"]
    first = _run_port(monkeypatch, argv, cfg)
    assert len(first) == len(PAIRS)
    before = open(report).read()
    again = _run_port(monkeypatch, argv + ["--resume"], cfg)
    assert again == [] and open(report).read() == before
    for flag in ("--pair-batch=4", "--devices=2", "--num-processes=2"):
        with pytest.raises(NotImplementedError):
            port_cli.main([match, clouds, flag])


@pytest.mark.parametrize("mode", ["binary", "ascii", "binary_compressed"])
def test_load_cloud_pcd_matches_pctpu(tmp_path, mode):
    rng = np.random.default_rng(4)
    n = 53
    cloud = jcloud.make_cloud(
        rng.uniform(-60, 60, (n, 3)).astype(np.float32),
        intensity=rng.random(n).astype(np.float32),
        row=rng.integers(0, 64, n), col=rng.integers(0, 2083, n),
        t=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        label=rng.integers(-2, 3, n),
    )
    path = str(tmp_path / "c.pcd")
    data = jpcd.cloud_to_pcd_dict(cloud)
    if mode == "binary_compressed":
        jpcd.write_pcd(path, data)
        blob = open(path, "rb").read()
        head = blob[: blob.index(b"DATA binary\n")]
        soa = b"".join(np.ascontiguousarray(data[f.name]).astype(f.dtype).tobytes()
                       for f in jpcd.XYZIRCT_FIELDS)
        comp = _lzf_compress_literals(soa)
        with open(path, "wb") as f:
            f.write(head + b"DATA binary_compressed\n")
            f.write(np.array([len(comp), len(soa)], np.uint32).tobytes() + comp)
    else:
        jpcd.write_pcd(path, data, binary=mode == "binary")
    ref = jcloud.to_numpy(jpcd.load_cloud_pcd(path, capacity=64))
    got = tpcd.load_cloud_pcd(path, capacity=64, device="cpu")
    assert got.count == ref["count"] == n
    for name in ("xyz", "intensity", "row", "col", "label"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name])
    np.testing.assert_array_equal(got.t.numpy(), ref["t"].astype(np.int64))
    # and the port writes the same bytes back
    out = str(tmp_path / "back.pcd")
    tpcd.save_cloud_pcd(out, got)
    jpcd.save_cloud_pcd(str(tmp_path / "ref.pcd"), jpcd.load_cloud_pcd(path))
    assert open(out, "rb").read() == open(tmp_path / "ref.pcd", "rb").read()
    assert os.path.getsize(out) > 0 and torch.equal(got.valid_mask()[:n], torch.ones(n, dtype=torch.bool))
