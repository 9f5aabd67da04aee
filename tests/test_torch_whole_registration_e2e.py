"""batch_whole_registration end to end: pctpu_torch's sequential driver and
CLI against pctpu's ``run_batch_whole_registration(pair_batch=1)`` on one
small keyframe tree, on the CPU.

The tree holds three clouds of the bench's verify scene (12 clusters of 150
points + 1,500 ground points, capacity 4,096, as bench.py builds it) under
known yaws and translations, and four pairs.  Both packages run the
default ``WHOLE_ICP`` (4 m, up to 200 iterations).  They must count the same
successes and failures and write byte-equal ``.progress`` sidecars and
(empty) reports.  Per pair the fine fitness and transform must agree
within the README's D5/D6 windows — transform entries within 1e-4 (the two
stacks sum in different orders, the D5/D6 class: ≤ 5e-5 measured for
pctpu's own reductions) and fitness within 1e-4 relative."""

import math

import numpy as np
import pytest

import pctpu.pipelines.registration as jreg
from pctpu.config import WHOLE_ICP as J_WHOLE_ICP
from pctpu.config import RegistrationConfig as JRegistrationConfig
from pctpu_torch import RegistrationConfig, make_cloud
from pctpu_torch.cli import batch_whole_registration as port_cli
from pctpu_torch.config import WHOLE_ICP
from pctpu_torch.io import pcd as tpcd
from pctpu_torch.pipelines import registration as port_reg

# (yaw in degrees, translation) of each cloud relative to the base scene
POSES = [(0.0, (0.0, 0.0)), (14.0, (1.2, -0.8)), (-9.0, (-0.6, 1.5))]
# (query, match, yaw guess): guesses 1-3° off the truth
PAIRS = [(0, 1, 12.0), (1, 2, -21.5), (2, 0, 11.0), (1, 0, -15.0)]


def _verify_scene(seed=500):
    """bench.py's on-device verify scene (bench.py:895-908)."""
    rng = np.random.default_rng(seed)
    pts, labels = [], []
    for _ in range(12):
        cx, cy = rng.uniform(-50, 50, 2)
        pts.append(np.stack([cx + rng.normal(0, 2.5, 150), cy + rng.normal(0, 2.5, 150),
                             rng.uniform(0, 9, 150)], 1))
        labels.append(np.full(150, -2))
    pts.append(np.stack([rng.uniform(-70, 70, 1500), rng.uniform(-70, 70, 1500),
                         rng.uniform(-2.0, -1.9, 1500)], 1))
    labels.append(np.zeros(1500))
    return np.concatenate(pts).astype(np.float32), np.concatenate(labels).astype(np.int32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("whole")
    clouds = root / "clouds"
    clouds.mkdir()
    xyz, lab = _verify_scene()
    rng = np.random.default_rng(501)
    for k, (yaw, (tx, ty)) in enumerate(POSES):
        th = math.radians(yaw)
        rot = np.array([[math.cos(th), -math.sin(th), 0], [math.sin(th), math.cos(th), 0],
                        [0, 0, 1]], np.float32)
        moved = (xyz @ rot.T + np.float32([tx, ty, 0])
                 + rng.normal(0, 0.01, xyz.shape)).astype(np.float32)
        tpcd.save_cloud_pcd(str(clouds / f"{k:06d}.pcd"),
                            make_cloud(moved, label=lab, capacity=4096, device="cpu"))
    match = root / "match_result.txt"
    match.write_text("".join(f"{q} {m} {g}\n" for q, m, g in PAIRS))
    return root, str(match), str(clouds)


def _recording(monkeypatch, module, out):
    """Wrap ``module.icp_point_to_point`` to keep each pair's (fitness,
    transform) as numpy."""
    real = module.icp_point_to_point

    def rec(*args, **kwargs):
        res = real(*args, **kwargs)
        t = res.transform
        out.append((float(np.asarray(res.fitness)),
                    np.asarray(t.cpu() if hasattr(t, "cpu") else t)))
        return res

    monkeypatch.setattr(module, "icp_point_to_point", rec)


def test_config_matches_pctpu():
    assert WHOLE_ICP.__dict__ == J_WHOLE_ICP.__dict__
    assert RegistrationConfig(fine=WHOLE_ICP).failure_fitness == JRegistrationConfig(
        fine=J_WHOLE_ICP).failure_fitness


def test_cli_matches_pctpu(tree, monkeypatch, capsys):
    root, match, clouds = tree
    ref, got = [], []
    _recording(monkeypatch, jreg, ref)
    _recording(monkeypatch, port_reg, got)
    ref_report = root / "pctpu_whole.txt"
    counts = jreg.run_batch_whole_registration(match, clouds, report_path=str(ref_report),
                                               pair_batch=1)
    port_report = root / "port_whole.txt"
    assert port_cli.main([match, clouds, f"--report={port_report}", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and "capacity auto-derived from headers: 8192" in out
    assert "[TIME] Avg Tiempo for 2nd Stage (fine)" in out
    assert f"count_success: {counts[0]}, count_failure: {counts[1]}," in out
    assert counts == (len(PAIRS), 0)

    assert port_report.read_bytes() == ref_report.read_bytes() == b""
    progress = (root / "port_whole.txt.progress").read_bytes()
    assert progress == (root / "pctpu_whole.txt.progress").read_bytes()
    assert progress.decode().splitlines() == [f"{q} {m}" for q, m, _ in PAIRS]

    assert len(ref) == len(got) == len(PAIRS)
    for (fit_r, tf_r), (fit_g, tf_g), (q, m, _) in zip(ref, got, PAIRS):
        assert abs(fit_g - fit_r) <= 1e-4 * fit_r
        np.testing.assert_allclose(tf_g, tf_r, atol=1e-4)
        # and the transform is the known relative pose
        yaw = math.degrees(math.atan2(tf_g[1, 0], tf_g[0, 0]))
        assert abs((yaw - (POSES[m][0] - POSES[q][0]) + 180.0) % 360.0 - 180.0) < 0.5


def test_failure_classification_matches_pctpu(tree, tmp_path):
    """With the failure gate below every fitness, both count each pair a
    failure and still record it in the sidecar."""
    _, match, clouds = tree
    cfg_j = JRegistrationConfig(fine=J_WHOLE_ICP, failure_fitness=-1.0)
    cfg_t = RegistrationConfig(fine=WHOLE_ICP, failure_fitness=-1.0)
    ref = jreg.run_batch_whole_registration(match, clouds, cfg=cfg_j, pair_batch=1,
                                            report_path=str(tmp_path / "j.txt"),
                                            capacity=4096)
    got = port_reg.run_batch_whole_registration(match, clouds, cfg=cfg_t, capacity=4096,
                                                report_path=str(tmp_path / "t.txt"), device="cpu")
    assert got == ref == (0, len(PAIRS))
    assert (tmp_path / "t.txt.progress").read_bytes() == (tmp_path / "j.txt.progress").read_bytes()


def test_cli_resume_usage_and_unported_flags(tree, monkeypatch, capsys):
    root, match, clouds = tree
    report = root / "resume_whole.txt"
    calls = []
    real = port_reg.icp_point_to_point
    monkeypatch.setattr(port_reg, "icp_point_to_point",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    argv = [match, clouds, f"--report={report}", "--capacity=4096", "--device=cpu"]
    assert port_cli.main(argv) == 0
    assert len(calls) == len(PAIRS)
    progress = (root / "resume_whole.txt.progress").read_text()
    assert port_cli.main(argv + ["--resume"]) == 0
    assert len(calls) == len(PAIRS)  # nothing left to run
    assert (root / "resume_whole.txt.progress").read_text() == progress
    assert report.read_bytes() == b"" and "count_success: 0, count_failure: 0," in (
        capsys.readouterr().out)
    with pytest.raises(SystemExit) as exc:
        port_cli.main([match])
    assert exc.value.code == 1
    assert capsys.readouterr().out.startswith(
        "Usage: batch_whole_registration <match_result.txt> <point_cloud_dir>")
    for flag in ("--pair-batch=4", "--devices=2", "--num-processes=2", "--process-id=1"):
        with pytest.raises(NotImplementedError):
            port_cli.main([match, clouds, flag])
    with pytest.raises(SystemExit):
        port_cli.main([match, clouds, "--capacity=big", "--device=cpu"])
