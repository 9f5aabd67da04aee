"""The BEV writes overlap the device loop in pctpu_torch's ``run_multi_bev``
(``runtime/writer.py::AsyncWriter``), on the CPU: the port's copies of the
two pipeline cases of ``tests/test_write_overlap.py`` (:60 and :154).  Its
three other cases test ``bench.py``'s plumbing and wait for the port's
bench leg.

With the writes stubbed to a fixed sleep (an IO-shaped cost that releases
the GIL, like the native writers), the loop wall must sit near
max(device, writes / workers): a writer inside the loop would add the
whole write total to it.  On real writes the tree equals pctpu's."""

import os
import time

import numpy as np
import pytest
import torch

import pctpu.pipelines.multi_bev as jmb
import pctpu.runtime.native_io as jnio
import pctpu_torch.pipelines.multi_bev as mb
from pctpu.config import SensorParams as JSensorParams
from pctpu_torch.config import SensorParams
from pctpu_torch.geom.se3 import Pose6f
from pctpu_torch.io.pcd import write_pcd
from pctpu_torch.io.poses import format_pose_entry

# a small sensor: the whole pipeline's semantics, little compute
SHAPE = dict(n_scan=16, horizon_scan=128, ground_upper_scan=12, height_res=0.25)
PARAMS = SensorParams(**SHAPE)


@pytest.fixture(autouse=True)
def _one_thread():
    # a pipeline beside other test workers: full intra-op pools contend
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _pctpu_csv_cells():
    """pctpu's native CSV formatter fills its table of cells at first use
    without a lock (ROADMAP F8): build it on one thread before pctpu's
    pipeline and its two writer threads run."""
    assert jnio.format_csv_u8(np.zeros((1, 1), np.uint8)) == b"  0"


def _make_selected_tree(root: str, n: int) -> None:
    g = PARAMS.grid_size
    os.makedirs(os.path.join(root, "keyframe_point_cloud"))
    rng = np.random.default_rng(0)
    rows = (np.arange(g) // PARAMS.horizon_scan).astype(np.uint16)
    cols = (np.arange(g) % PARAMS.horizon_scan).astype(np.uint16)
    lines = []
    for i in range(n):
        r = rng.uniform(3, 60, g).astype(np.float32)
        az = rng.uniform(0, 2 * np.pi, g).astype(np.float32)
        write_pcd(os.path.join(root, "keyframe_point_cloud", f"{i:06d}.pcd"), {
            "x": r * np.cos(az), "y": r * np.sin(az),
            "z": rng.uniform(-2, 5, g).astype(np.float32),
            "intensity": rng.uniform(0.01, 1, g).astype(np.float32),
            "row": rows, "col": cols, "t": np.zeros(g, np.uint32),
            "label": np.full(g, -2, np.int16),
        }, width=g)
        lines.append(format_pose_entry(
            i, Pose6f.from_matrix(np.eye(3), np.array([3.0 * i, 0.0, 0.0]))))
    with open(os.path.join(root, "keyframe_pose.csv"), "w") as f:
        f.writelines(lines)


def test_writes_overlap_device_loop(tmp_path, monkeypatch):
    n = 12
    sleep_s = 0.15
    root = str(tmp_path / "tree")
    _make_selected_tree(root, n)

    def slow_write(*args):
        # _write_outputs' signature: the timer is the last positional
        time.sleep(sleep_s)
        args[-1].add("bev-write", sleep_s * 1e3)

    monkeypatch.setattr(mb, "_write_outputs", slow_write)
    out = mb.run_multi_bev(root, PARAMS, batch_size=2, device="cpu")
    assert out.num_clouds == n
    write_total_ms = n * sleep_s * 1e3
    device_total_ms = out.avg_device_ms_per_cloud * n
    # the loop wall also holds the prefetched loads and the threads'
    # scheduling; a writer inside the loop would make this >= write_total
    visible_write_ms = out.loop_wall_ms - device_total_ms
    assert visible_write_ms < 0.65 * write_total_ms, (
        f"writes not overlapped: wall {out.loop_wall_ms:.0f} ms, device "
        f"{device_total_ms:.0f} ms, writes {write_total_ms:.0f} ms")
    # two writer threads: the writes alone take about half their total
    assert out.loop_wall_ms >= 0.5 * write_total_ms * 0.9
    # the serial-sum convention upper-bounds the measured span
    assert out.wall_ms_per_cloud < out.avg_ms_per_cloud
    # and still reports the whole write cost
    assert abs(out.avg_bev_write_ms_per_cloud - sleep_s * 1e3) < 20.0


def test_loop_wall_recorded_on_real_writes(tmp_path):
    root, jroot = str(tmp_path / "tree"), str(tmp_path / "jtree")
    _make_selected_tree(root, 3)
    _make_selected_tree(jroot, 3)
    out = mb.run_multi_bev(root, PARAMS, batch_size=2, device="cpu")
    assert out.num_clouds == 3
    assert out.loop_wall_ms > 0.0
    assert out.wall_ms_per_cloud == out.loop_wall_ms / 3
    assert sorted(os.listdir(os.path.join(root, "output_multi_bev", "binary"))) == [
        "000000.bin", "000001.bin", "000002.bin"]
    jout = jmb.run_multi_bev(jroot, JSensorParams(**SHAPE), batch_size=2)
    assert (out.num_clouds, out.num_major_frames) == (jout.num_clouds, jout.num_major_frames)
    for sub in ("output_multi_bev", "output_single_bev", "non_ground_point_cloud"):
        for dirpath, _, files in os.walk(os.path.join(jroot, sub)):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), jroot)
                with open(os.path.join(jroot, rel), "rb") as a, \
                        open(os.path.join(root, rel), "rb") as b:
                    assert a.read() == b.read(), rel
    with open(os.path.join(jroot, "keyframe_label.csv"), "rb") as a, \
            open(os.path.join(root, "keyframe_label.csv"), "rb") as b:
        assert a.read() == b.read()
