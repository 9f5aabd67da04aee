"""End to end: pctpu's ``run_multi_bev`` and the port's pipeline and CLI
write byte-identical batch_multi_bev_gen trees on the CPU — every ``.bin``,
PNG, CSV, non-ground PCD and ``keyframe_label.csv`` — in both compat modes.

The input trees are ray-cast drives (``pctpu_torch.experiments.scene``):
grid-ordered clouds (the fast path), raw clouds with duplicate cells and
out-of-range rings (the general ordering) and a cloud over the grid's
capacity (the host last-wins compaction)."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import pctpu.runtime.native_io as jnio
from pctpu.config import SensorParams as JSensorParams
from pctpu.pipelines.multi_bev import run_multi_bev as jrun
from pctpu.runtime.loader import load_xyzirct_arrays as jload
from pctpu_torch.cli import batch_multi_bev_gen as cli
from pctpu_torch.config import SensorParams, get_sensor_params
from pctpu_torch.experiments.scene import multi_bev_tree
from pctpu_torch.io.pcd import read_pcd
from pctpu_torch.pipelines.multi_bev import run_multi_bev
from pctpu_torch.runtime import native_io
from pctpu_torch.runtime.loader import load_xyzirct_arrays

SMALL = (16, 256, 10, 0.5)
OUTPUTS = ("non_ground_point_cloud", "output_multi_bev", "output_single_bev")


@pytest.fixture(autouse=True, scope="module")
def _pctpu_csv_cells():
    """pctpu's native CSV formatter (``native/pctpu_io.cpp``) fills its table
    of cells at first use without a lock, and pctpu's two writer threads can
    race there and write NUL bytes into pctpu's tree (ROADMAP F8; the port's
    loader builds its own copy's table first).  Build pctpu's once, on one
    thread, before its pipeline runs."""
    assert jnio.format_csv_u8(np.zeros((1, 1), np.uint8)) == b"  0"


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
    pb = run_multi_bev(b, SensorParams(*SMALL), batch_size=4, compat=compat, device="cpu")
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
    assert cli.main([b, "HDL_32E", "--batch-size=2", "--device=cpu"]) == 0
    assert_same_tree(a, b)

    os.remove(os.path.join(b, "non_ground_point_cloud", "000001.pcd"))
    os.remove(os.path.join(b, "output_multi_bev", "binary", "000001.bin"))
    capsys.readouterr()
    assert cli.main([b, "HDL_32E", "--batch-size=2", "--resume", "--device=cpu"]) == 0
    log = capsys.readouterr().out
    assert "Converting file: 000001" in log
    assert "Converting file: 000000" not in log and "Converting file: 000002" not in log
    assert "BEV writer: " in log and "[TIME] Average preprocessing" in log
    assert_same_tree(a, b)

    c = str(tmp_path / "no_pngs")
    shutil.copytree(src, c)
    assert cli.main([c, "HDL_32E", "--batch-size=2", "--no-pngs", "--device=cpu"]) == 0
    fa, fc = output_files(a), output_files(c)
    assert not any(k.endswith(".png") for k in fc)
    assert fc == {k: v for k, v in fa.items() if not k.endswith(".png")}


def test_wall_ms_per_cloud(small_tree, tmp_path):
    """``MultiBevOutputs.wall_ms_per_cloud`` is the loop's wall over the
    clouds done, as pctpu's."""
    root = str(tmp_path / "port")
    shutil.copytree(small_tree, root)
    out = run_multi_bev(root, SensorParams(*SMALL), batch_size=4, device="cpu")
    assert out.loop_wall_ms > 0.0
    assert out.wall_ms_per_cloud == out.loop_wall_ms / 8
    assert dataclasses.replace(out, num_clouds=0).wall_ms_per_cloud == 0.0


@pytest.mark.parametrize("with_params", [False, True])
def test_loader_matches_pctpu_on_an_over_capacity_cloud(small_tree, with_params):
    """``load_xyzirct_arrays(path, capacity, params=None)``: without
    ``params`` an oversized cloud truncates, with them it is compacted to
    its per-cell last-wins winners — pctpu's arrays either way."""
    path = os.path.join(small_tree, "keyframe_point_cloud", "000007.pcd")
    params, jparams = SensorParams(*SMALL), JSensorParams(*SMALL)
    kw, jkw = ({"params": params}, {"params": jparams}) if with_params else ({}, {})
    got = load_xyzirct_arrays(path, params.grid_size, **kw)
    want = jload(path, jparams.grid_size, **jkw)
    assert read_pcd(path)[1]["points"] > params.grid_size
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["count"]) <= params.grid_size
    if not with_params:
        assert int(got["count"]) == params.grid_size


def test_package_exports_match_pctpu():
    """``pctpu_torch`` exports everything ``pctpu`` does, plus its own config
    and array helpers."""
    import pctpu
    import pctpu_torch

    assert set(pctpu.__all__) - set(pctpu_torch.__all__) == set()
    assert set(pctpu_torch.__all__) - set(pctpu.__all__) == {
        "IcpConfig", "from_numpy", "registration_config_from"}
    for name in pctpu_torch.__all__:
        assert getattr(pctpu_torch, name) is not None
    hdl64 = pctpu_torch.get_sensor_params(pctpu_torch.parse_sensor_type("HDL_64E"))
    assert isinstance(hdl64, pctpu_torch.SensorParams) and hdl64.n_scan == 64


def test_cli_rejects_unported_flags(tmp_path, monkeypatch):
    """pctpu's --devices, multi-process and --profile flags are all taken
    now (tests/test_torch_parallel.py runs them); a mesh of more cards than
    the process sees, or a malformed count, is still refused."""
    # one card: a data mesh of two needs two, and the run stops (exit 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "one card")
    for flag, code in (("--devices=2", 2), ("--devices=two", 1), ("--num-processes=x", 1)):
        with pytest.raises(SystemExit) as exc:
            cli.main([str(tmp_path), "HDL_64E", flag])
        assert exc.value.code == code, flag


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
