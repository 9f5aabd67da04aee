"""End to end: pctpu's ``run_multi_bev`` and the port's pipeline and CLI
write byte-identical batch_multi_bev_gen trees on the CPU — every ``.bin``,
PNG, CSV, non-ground PCD and ``keyframe_label.csv`` — in both compat modes.

The input trees are ray-cast drives (``pctpu_torch.experiments.scene``):
grid-ordered clouds (the fast path), raw clouds with duplicate cells and
out-of-range rings (the general ordering) and a cloud over the grid's
capacity (the host last-wins compaction)."""

import os
import shutil

import numpy as np
import pytest

from pctpu.config import SensorParams as JSensorParams
from pctpu.pipelines.multi_bev import run_multi_bev as jrun
from pctpu_torch.cli import batch_multi_bev_gen as cli
from pctpu_torch.config import SensorParams, get_sensor_params
from pctpu_torch.experiments.scene import multi_bev_tree
from pctpu_torch.pipelines.multi_bev import run_multi_bev
from pctpu_torch.runtime import native_io

SMALL = (16, 256, 10, 0.5)
OUTPUTS = ("non_ground_point_cloud", "output_multi_bev", "output_single_bev")


def output_files(root) -> dict[str, bytes]:
    files = {}
    for sub in OUTPUTS:
        for dirpath, _, names in os.walk(os.path.join(root, sub)):
            for n in names:
                path = os.path.join(dirpath, n)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, root)] = f.read()
    with open(os.path.join(root, "keyframe_label.csv"), "rb") as f:
        files["keyframe_label.csv"] = f.read()
    return files


def assert_same_tree(a, b):
    fa, fb = output_files(a), output_files(b)
    assert sorted(fa) == sorted(fb)
    diff = [k for k in fa if fa[k] != fb[k]]
    assert not diff, f"{len(diff)} files differ, e.g. {diff[:5]}"


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mbev") / "src")
    paths = multi_bev_tree(root, SensorParams(*SMALL), n_ordered=5, n_raw=2, n_over=1, seed=3)
    assert len(paths) == 8
    return root


@pytest.mark.parametrize("compat", ["bitexact", "tolerance"])
def test_pipeline_tree_byte_identical_to_pctpu(small_tree, tmp_path, compat):
    a, b = str(tmp_path / "pctpu"), str(tmp_path / "port")
    shutil.copytree(small_tree, a)
    shutil.copytree(small_tree, b)
    ja = jrun(a, JSensorParams(*SMALL), batch_size=4, compat=compat)
    pb = run_multi_bev(b, SensorParams(*SMALL), batch_size=4, compat=compat)
    assert (pb.num_clouds, pb.num_major_frames) == (ja.num_clouds, ja.num_major_frames) == (8, 2)
    assert len(os.listdir(os.path.join(b, "output_multi_bev", "image"))) == 8
    assert_same_tree(a, b)


def test_cli_and_resume_byte_identical_to_pctpu(tmp_path, capsys):
    """The port's CLI (same argv) on an HDL-32E drive equals pctpu's
    pipeline; ``--resume`` redoes exactly the clouds whose outputs are
    missing and leaves the tree byte-identical; ``--no-pngs`` writes the
    same tree without its PNGs."""
    src = str(tmp_path / "src")
    multi_bev_tree(src, get_sensor_params("HDL_32E"), n_ordered=2, n_raw=1, n_over=0, seed=5)
    a, b = str(tmp_path / "pctpu"), str(tmp_path / "port")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    jrun(a, "HDL_32E", batch_size=2)
    assert cli.main([b, "HDL_32E", "--batch-size=2"]) == 0
    assert_same_tree(a, b)

    os.remove(os.path.join(b, "non_ground_point_cloud", "000001.pcd"))
    os.remove(os.path.join(b, "output_multi_bev", "binary", "000001.bin"))
    capsys.readouterr()
    assert cli.main([b, "HDL_32E", "--batch-size=2", "--resume"]) == 0
    log = capsys.readouterr().out
    assert "Converting file: 000001" in log
    assert "Converting file: 000000" not in log and "Converting file: 000002" not in log
    assert "BEV writer: " in log and "[TIME] Average preprocessing" in log
    assert_same_tree(a, b)

    c = str(tmp_path / "no_pngs")
    shutil.copytree(src, c)
    assert cli.main([c, "HDL_32E", "--batch-size=2", "--no-pngs"]) == 0
    fa, fc = output_files(a), output_files(c)
    assert not any(k.endswith(".png") for k in fc)
    assert fc == {k: v for k, v in fa.items() if not k.endswith(".png")}


def test_cli_rejects_unported_flags(tmp_path):
    for flag in ("--devices=2", "--num-processes=2", "--profile=x"):
        with pytest.raises(NotImplementedError):
            cli.main([str(tmp_path), "HDL_64E", flag])


def test_python_writers_match_native(tmp_path):
    """Where the native writer cannot be built, the Python writers write the
    same bytes."""
    rng = np.random.default_rng(0)
    multi = (rng.random((24, 224, 224)) < 0.02).astype(np.uint8) * 255
    single = np.where(rng.random((224, 224)) < 0.1, rng.integers(0, 256, (224, 224)),
                      0).astype(np.uint8)
    trees = []
    for kind in ("native", "python"):
        d = tmp_path / kind
        d.mkdir()
        args = (str(d / "c.bin"), str(d / "img") + "/", str(d / "s.png"), str(d / "s.csv"),
                single, multi)
        if kind == "native":
            assert native_io.writer_name().startswith("native")
            native_io.write_cloud_artifacts(*args)
        else:
            native_io.write_cloud_artifacts_python(*args)
        trees.append({os.path.relpath(os.path.join(p, n), d): open(os.path.join(p, n), "rb").read()
                      for p, _, ns in os.walk(d) for n in ns})
    assert len(trees[0]) == 27 and trees[0] == trees[1]
