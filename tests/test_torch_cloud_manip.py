"""batch_cloud_manip and cloud_manip in the port against pctpu on the CPU:
the float max-height BEV (and the native oracle's), the float and int CSV
formatters on both routes, the gray PNG levels and the float → uint8
conversion, the rigid transform, ``report_average``, and both pipelines'
trees and both CLIs byte for byte on the same inputs."""

import math
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import pctpu.pipelines.batch_cloud_manip as jbcm
from pctpu.cli import cloud_manip as jcm_cli
from pctpu.cloud import make_cloud as jmake_cloud
from pctpu.config import FloatBevConfig as JFloatBevConfig
from pctpu.config import SensorParams as JSensorParams
from pctpu.io.csvfmt import format_csv_bytes as jformat_csv
from pctpu.io.png import encode_gray_png as jencode_gray
from pctpu.ops.bev import float_bev as jfloat_bev
from pctpu.ops.rounding import cv_saturate_u8 as jsaturate
from pctpu.ops.transform import make_rigid_transform as jrigid
from pctpu.ops.transform import transform_cloud as jtransform_cloud
from pctpu.pipelines.cloud_manip import run_cloud_manip as jrun_cloud_manip
from pctpu.runtime.profiler import StageTimer as JStageTimer
from pctpu_torch.cli import batch_cloud_manip as bcm_cli
from pctpu_torch.cli import cloud_manip as cm_cli
from pctpu_torch.cloud import make_cloud, stack_clouds
from pctpu_torch.config import FloatBevConfig, SensorParams
from pctpu_torch.experiments import oracle as port_oracle
from pctpu_torch.experiments.scene import multi_bev_tree
from pctpu_torch.io import csvfmt
from pctpu_torch.io.pcd import write_pcd
from pctpu_torch.io.png import decode_gray_png, encode_gray_png
from pctpu_torch.ops.bev import float_bev
from pctpu_torch.ops.rounding import cv_saturate_u8
from pctpu_torch.ops.transform import (make_rigid_transform, transform_cloud, transform_xyz,
                                      transform_xyz_rounded)
from pctpu_torch.pipelines import batch_cloud_manip as bcm
from pctpu_torch.pipelines.cloud_manip import run_cloud_manip
from pctpu_torch.runtime import native_io
from pctpu_torch.runtime.profiler import StageTimer

from . import native_oracle

SMALL = (16, 256, 10, 0.5)


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# --- the float BEV ------------------------------------------------------------


def _bev_cloud(seed: int, n: int = 3000, nan: bool = False):
    """Points over ±115 m (some outside the 201² grid), a share exactly on
    cell edges (``bev_cell``'s -0.5 / +0.5 boundaries and one ulp either
    side), heights with z + 2 < 0, ground labels; with ``nan``, NaN heights
    on in-range non-ground points."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-115, 115, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-4.5, 6, n)
    edge = rng.integers(-101, 101, (n // 5, 2)).astype(np.float32) - np.float32(0.5)
    edge = np.nextafter(edge, rng.choice([-np.inf, np.inf], edge.shape).astype(np.float32)) \
        if seed % 2 else edge
    xyz[: n // 5, :2] = edge
    label = np.where(rng.random(n) < 0.3, 0, rng.integers(1, 5, n)).astype(np.int32)
    if nan:
        pick = np.flatnonzero((np.abs(xyz[:, 0]) < 90) & (np.abs(xyz[:, 1]) < 90)
                              & (label != 0))[:7]
        xyz[pick, 2] = np.nan
        xyz[pick[0], 2] = -np.float32(np.nan)  # a sign-set NaN alone in its cell
        xyz[pick[0], :2] = [150.25, 0.5]  # outside: never in an image
        xyz[pick[1], :2] = [3.25, 3.25]
    return xyz, label


@pytest.mark.parametrize("filter_ground", [True, False])
@pytest.mark.parametrize("seed,nan", [(0, False), (1, False), (2, True), (3, True)])
def test_float_bev_bit_equal_to_pctpu(seed, nan, filter_ground):
    """Single clouds and a batch of three equal pctpu's float BEV bit for
    bit (a NaN height carries into its cell in both), and the native
    oracle's wherever no NaN reached the cell (its ``v > out`` never stores
    a NaN)."""
    cfg = FloatBevConfig(filter_ground=filter_ground)
    clouds = [_bev_cloud(seed + 10 * k, n=3000 - 7 * k, nan=nan) for k in range(3)]
    port = [make_cloud(x, label=l, capacity=3000, device="cpu") for x, l in clouds]
    batched = float_bev(stack_clouds(port), cfg).numpy()
    assert batched.shape == (3, 201, 201) and batched.dtype == np.float32
    for k, (xyz, label) in enumerate(clouds):
        want = np.asarray(jfloat_bev(jmake_cloud(xyz, label=label, capacity=3000),
                                     JFloatBevConfig(filter_ground=filter_ground)))
        single = float_bev(port[k], cfg).numpy()
        assert np.array_equal(bits(single), bits(want))
        assert np.array_equal(bits(batched[k]), bits(want))
        oracle = native_oracle.float_bev(xyz, label, filter_ground)
        assert np.array_equal(bits(oracle), bits(port_oracle.float_bev(
            port_oracle.load(), xyz, label, filter_ground)))
        clean = ~np.isnan(want)
        assert np.array_equal(bits(want[clean]), bits(oracle[clean]))
        assert (want < 0).sum() == 0 and (want > 0).sum() > 1000
        if nan:
            assert np.isnan(want).sum() >= 3 and np.isnan(want[104, 104])


def test_float_bev_nan_cell_holds_the_nan_it_was_given():
    """pctpu's scatter-max carries a NaN into its cell with its sign; the
    port's twin does the same for every cell that receives NaNs of one bit
    pattern (README D21 covers cells given differently signed NaNs)."""
    xyz = np.array([[0.2, 0.2, 1.0], [0.3, 0.3, np.nan], [5.2, 5.2, -np.float32(np.nan)],
                    [5.3, 5.2, 3.0], [9.2, 9.2, np.nan], [9.3, 9.3, np.nan]], np.float32)
    label = np.ones(6, np.int32)
    want = np.asarray(jfloat_bev(jmake_cloud(xyz, label=label), JFloatBevConfig()))
    got = float_bev(make_cloud(xyz, label=label, device="cpu")).numpy()
    assert np.array_equal(bits(got), bits(want))
    assert np.isnan(got[101, 101]) and not np.signbit(got[101, 101])
    assert np.isnan(got[106, 106]) and np.signbit(got[106, 106])
    assert csvfmt.format_csv_bytes(got[106:107, 105:108]) == b"0, -nan, 0"
    # D21: NaNs of both signs in one cell leave a NaN in both packages
    mixed = np.concatenate([xyz, [[9.25, 9.25, -np.float32(np.nan)]]]).astype(np.float32)
    want = np.asarray(jfloat_bev(jmake_cloud(mixed, label=np.ones(7, np.int32)),
                                 JFloatBevConfig()))
    got = float_bev(make_cloud(mixed, label=np.ones(7, np.int32), device="cpu")).numpy()
    assert np.isnan(want[110, 110]) and np.isnan(got[110, 110])
    clean = np.ones(want.shape, bool)
    clean[110, 110] = False
    assert np.array_equal(bits(got[clean]), bits(want[clean]))


# --- the CSV formatters -------------------------------------------------------


def _special_values(dtype) -> np.ndarray:
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        rng.normal(0, 3, 40), rng.uniform(-1e6, 1e6, 20), 10.0 ** rng.uniform(-45, 38, 30),
        [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-40, -1e-45, 3.4e38, -3.4e38,
         0.5, 1.5, 99995.0, 123456.7, 1e-5, 0.0001, 2.0, 201.0, -2.5],
    ])
    with np.errstate(over="ignore"):
        return vals.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(9, 11), (1, 99), (99, 1)])
@pytest.mark.parametrize("precision", [4, 7])
def test_float_csv_equal_to_pctpu_on_both_routes(dtype, shape, precision):
    """``%.{p}g`` with glibc's ``-nan``, ``", "`` joins and no trailing
    newline on a single row: the native route (float32 with the library)
    and the Python route both write pctpu's bytes."""
    mat = _special_values(dtype)[: shape[0] * shape[1]].reshape(shape)
    want = jformat_csv(mat, precision)
    assert csvfmt.format_csv_bytes(mat, precision) == want
    assert csvfmt.format_csv_python(mat, precision) == want
    assert csvfmt.csv_route(mat) == ("native" if dtype == np.float32 else "python")
    if dtype == np.float32:
        assert native_io.format_csv_f32(mat, precision) == want
    assert b"-nan" in want and b"inf" in want and want.endswith(b"\n") == (shape[0] > 1)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint16, np.int8, np.uint8])
def test_int_csv_equal_to_pctpu(dtype):
    rng = np.random.default_rng(2)
    info = np.iinfo(dtype)
    mat = rng.integers(info.min, int(info.max) + 1, (13, 17)).astype(dtype)
    mat[0, :3] = [info.min, info.max, 0]
    for m in (mat, mat[:1], mat[:, :1]):
        assert csvfmt.format_csv_bytes(m) == jformat_csv(m)
        assert csvfmt.format_csv_python(m) == jformat_csv(m)


def test_csv_rejects_what_pctpu_rejects():
    with pytest.raises(ValueError):
        csvfmt.format_csv_bytes(np.zeros((2, 2, 2), np.float32))
    with pytest.raises(TypeError):
        csvfmt.format_csv_bytes(np.zeros((2, 2), np.int64))
    assert csvfmt.format_csv_bytes(np.zeros((0, 3), np.float32)) == jformat_csv(
        np.zeros((0, 3), np.float32)) == b""


# --- PNGs and the float → uint8 conversion -------------------------------------


def test_cv_saturate_u8_equal_to_pctpu_and_pins_nan():
    """rint half-to-even, clamp to 0..255, then uint8; a NaN cell becomes
    what numpy's cast of NaN to uint8 gives, in both packages."""
    v = np.array([np.nan, -np.nan, np.inf, -np.inf, -3.0, -0.5, 0.5, 1.5, 2.5, 254.5, 255.5,
                  300.0, 127.49, 1e-40], np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, want = cv_saturate_u8(v), jsaturate(v)
        nan_u8 = np.array([np.nan], np.float32).astype(np.uint8)[0]
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert got[0] == got[1] == nan_u8
    assert got[2:].tolist() == [255, 0, 0, 0, 0, 2, 2, 254, 255, 255, 127, 0]


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("kind", ["uint8", "float BEV", "float with NaN"])
def test_gray_png_bytes_equal_to_pctpu(level, kind):
    rng = np.random.default_rng(level)
    img = np.where(rng.random((201, 201)) < 0.2, rng.uniform(-1, 300, (201, 201)), 0)
    if kind == "uint8":
        img = cv_saturate_u8(img)
    else:
        img = img.astype(np.float32)
        if kind == "float with NaN":
            img[::17, ::13] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, want = encode_gray_png(img, level), jencode_gray(img, level)
        assert got == want
        assert np.array_equal(decode_gray_png(got), cv_saturate_u8(img))


def test_gray_png_default_level_is_pctpu_s():
    img = np.random.default_rng(0).uniform(0, 40, (33, 20)).astype(np.float32)
    assert encode_gray_png(img) == jencode_gray(img) == jencode_gray(img, 6)
    assert encode_gray_png(img) != encode_gray_png(img, 1)
    with pytest.raises(ValueError):
        encode_gray_png(np.zeros((2, 2, 2), np.uint8))


# --- the rigid transform --------------------------------------------------------


def _yaws() -> list[float]:
    rng = np.random.default_rng(11)
    return [0.0, 30.0, -30.0, 90.0, -90.0, 180.0, -180.0, 359.99, 1e-3, -1e-3, 45.0, 270.0,
            17.0, -25.0, 178.0, 360.0, 720.0, 1e-7] + list(np.linspace(-360, 360, 1501)) \
        + list(rng.uniform(-720, 720, 700))


def test_make_rigid_transform_bit_equal_over_the_yaw_sweep():
    """2,219 yaws (the named angles, a 0.48° ramp over ±360°, 700 random
    angles in ±720°): every 4×4 bit-equal to pctpu's."""
    rng = np.random.default_rng(3)
    bad = []
    for yaw in _yaws():
        tx, ty, tz = rng.uniform(-50, 50, 3)
        theta = yaw / 180.0 * math.pi
        got = make_rigid_transform(tx, ty, tz, theta)
        want = np.asarray(jrigid(tx, ty, tz, theta))
        assert got.dtype.is_floating_point and tuple(got.shape) == (4, 4)
        if not np.array_equal(bits(got.numpy()), bits(want)):
            bad.append(yaw)
    assert len(_yaws()) >= 2000 and not bad, bad[:5]


@pytest.mark.parametrize("yaw", [30.0, -117.3, 359.99])
def test_transform_cloud_bit_equal_to_pctpu(yaw):
    rng = np.random.default_rng(int(abs(yaw)))
    xyz = rng.uniform(-120, 120, (5000, 3)).astype(np.float32)
    theta = yaw / 180.0 * math.pi
    got = transform_cloud(make_cloud(xyz, capacity=5100, device="cpu"),
                          make_rigid_transform(1.5, -2.25, 0.3, theta))
    want = jtransform_cloud(jmake_cloud(xyz, capacity=5100), jrigid(1.5, -2.25, 0.3, theta))
    assert np.array_equal(bits(got.xyz.numpy()), bits(np.asarray(want.xyz)))
    assert got.count == 5000


def test_transform_cloud_non_finite_points_equal_to_pctpu():
    """NaN (either sign, a signalling one) and infinite coordinates: the
    moved points' bits equal pctpu's wherever a point's NaN coordinates
    share one bit pattern and no infinity makes a NaN beside them; otherwise
    (differently signed NaNs, or inf·0 beside a NaN) both give a NaN in the
    same coordinates (README D21)."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    nan, neg = np.float32(np.nan), -np.float32(np.nan)
    snan = np.array([0x7F800001], np.uint32).view(np.float32)[0]
    rows = [[nan, 1, 2], [neg, 1, 2], [np.inf, 1, 2], [-np.inf, 1, 2], [1, np.inf, 2],
            [1, -np.inf, np.inf], [np.inf, np.inf, 2], [np.inf, -np.inf, 3],
            [nan, nan, nan], [neg, neg, neg], [snan, 1, 2], [1, 2, neg]]
    mixed = [[nan, neg, np.inf], [neg, nan, neg], [np.inf, -np.inf, nan]]
    xyz[: len(rows) + len(mixed)] = rows + mixed
    for yaw in (30.0, 0.0, 90.0, -117.3):
        theta = yaw / 180.0 * math.pi
        want = np.asarray(jtransform_cloud(jmake_cloud(xyz), jrigid(1.0, 2.0, 0.5, theta)).xyz)
        got = transform_cloud(make_cloud(xyz, device="cpu"),
                              make_rigid_transform(1.0, 2.0, 0.5, theta)).xyz.numpy()
        same = np.ones(64, bool)
        same[len(rows): len(rows) + len(mixed)] = False
        assert np.array_equal(bits(got[same]), bits(want[same]))
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(want[: len(rows)]).sum() > 10


def test_x86_nan_undoes_the_card_s_canonical_nan():
    """Where the card's float units return their canonical NaN 0x7FFFFFFF,
    ``x86_nan`` gives back the bits of the CPU's result: the NaN operand
    quieted, or 0xFFC00000 for a NaN made by inf·0 or inf − inf."""
    from pctpu_torch.ops.rounding import x86_nan

    a = torch.tensor([np.nan, -np.nan, np.inf, np.inf, 1.0, 3.0,
                      np.array([0x7F800001], np.uint32).view(np.float32)[0]])
    b = torch.tensor([2.0, 2.0, 0.0, -np.inf, np.nan, 2.0, 1.0])
    for res in (a * b, a + b):
        cpu = x86_nan(res, a, b)
        assert torch.equal(cpu.view(torch.int32), res.view(torch.int32))
        card = torch.where(torch.isnan(res), torch.tensor(0x7FFFFFFF, dtype=torch.int32)
                           .view(torch.float32), res)
        assert torch.equal(x86_nan(card, a, b).view(torch.int32), res.view(torch.int32))


def test_transform_cloud_general_matrix_window():
    """README D20: with a general 4×4 (a third row other than (0, 0, 1)),
    pctpu's eager dot gives its third coordinate as XLA's fma chain (the
    port's ``transform_xyz``) where ``transform_cloud`` rounds each product
    and sum; the first two coordinates stay bit-equal, and the third lies
    within 2^-21 (|x·m20| + |y·m21| + |z·m22| + |m23|) of pctpu's."""
    rng = np.random.default_rng(20)
    for _ in range(20):
        xyz = rng.uniform(-120, 120, (4000, 3)).astype(np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rng.normal(size=(3, 3))
        m[:3, 3] = rng.normal(size=3)
        want = np.asarray(jtransform_cloud(jmake_cloud(xyz), m).xyz)
        got = transform_cloud(make_cloud(xyz, device="cpu"), torch.from_numpy(m)).xyz.numpy()
        assert np.array_equal(got, transform_xyz_rounded(torch.from_numpy(xyz),
                                                         torch.from_numpy(m)).numpy())
        assert np.array_equal(bits(got[:, :2]), bits(want[:, :2]))
        fma = transform_xyz(torch.from_numpy(xyz), torch.from_numpy(m)).numpy()
        assert np.array_equal(bits(fma[:, 2]), bits(want[:, 2]))
        scale = (np.abs(xyz.astype(np.float64)) * np.abs(m[2, :3])).sum(1) + abs(m[2, 3])
        assert np.all(np.abs(got[:, 2].astype(np.float64) - want[:, 2]) <= 2.0 ** -21 * scale)


def test_report_average_equal_to_pctpu():
    port, ref = StageTimer(), JStageTimer()
    for t in (StageTimer(), JStageTimer()):
        assert t.report_average("bev", "Average x") == "[TIME] Average x: 0.0"
    for ms, items in ((12.5, 3), (0.1, 1), (7.0, 2)):
        port.add("bev", ms, items)
        ref.add("bev", ms, items)
    assert port.report_average("bev", "Average preprocessing and BEV generation") == \
        ref.report_average("bev", "Average preprocessing and BEV generation") == \
        f"[TIME] Average preprocessing and BEV generation: {19.6 / 6}"


# --- batch_cloud_manip end to end ------------------------------------------------


def tree_files(root: str) -> dict[str, bytes]:
    files = {}
    for sub in ("non_ground_point_cloud", "output_bvm"):
        for name in sorted(os.listdir(os.path.join(root, sub))):
            with open(os.path.join(root, sub, name), "rb") as f:
                files[f"{sub}/{name}"] = f.read()
    return files


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """A ray-cast drive at a small sensor: grid-ordered clouds, raw clouds
    with duplicate cells and one over the grid's capacity (truncated by the
    loader, as pctpu's batch_cloud_manip loads it)."""
    root = str(tmp_path_factory.mktemp("bcm") / "src")
    multi_bev_tree(root, SensorParams(*SMALL), n_ordered=2, n_raw=2, n_over=1, seed=4)
    return root


@pytest.mark.parametrize("compat", ["bitexact", "tolerance"])
def test_batch_cloud_manip_tree_byte_identical_to_pctpu(drive, tmp_path, monkeypatch, compat):
    """Five clouds at batch_size=2 (a padded tail): every CSV, PNG and
    labeled PCD byte-identical to pctpu's, the log's ``[TIME]`` line and
    the return value pctpu's in form."""
    monkeypatch.setattr(jbcm, "HDL64E", JSensorParams(*SMALL))
    monkeypatch.setattr(bcm, "HDL64E", SensorParams(*SMALL))
    a, b = str(tmp_path / "pctpu"), str(tmp_path / "port")
    shutil.copytree(drive, a)
    shutil.copytree(drive, b)
    jbcm.run_batch_cloud_manip(a, batch_size=2, compat=compat)
    avg = bcm.run_batch_cloud_manip(b, batch_size=2, compat=compat, device="cpu")
    assert avg > 0.0
    fa, fb = tree_files(a), tree_files(b)
    assert len(fa) == 15 and sorted(fa) == sorted(fb)
    assert [k for k in fa if fa[k] != fb[k]] == []


def test_batch_cloud_manip_cli_resume_byte_identical_to_pctpu(drive, tmp_path, monkeypatch,
                                                              capsys):
    """The port's CLI (pctpu's argv plus ``--device``) equals pctpu's run;
    ``--resume`` redoes exactly the clouds whose labeled PCD is missing and
    leaves the tree byte-identical; without it the directories are
    rebuilt."""
    monkeypatch.setattr(jbcm, "HDL64E", JSensorParams(*SMALL))
    monkeypatch.setattr(bcm, "HDL64E", SensorParams(*SMALL))
    a, b = str(tmp_path / "pctpu"), str(tmp_path / "port")
    shutil.copytree(drive, a)
    shutil.copytree(drive, b)
    jbcm.run_batch_cloud_manip(a, batch_size=3)
    assert bcm_cli.main([b, "--batch_size=3", "--device=cpu"]) == 0
    log = capsys.readouterr().out
    assert "device: cpu" in log and "Converting file: 000004" in log
    assert "[TIME] Average preprocessing and BEV generation: " in log and "Done. " in log
    assert tree_files(a) == tree_files(b)

    csv0 = os.path.join(b, "output_bvm", "000000.csv")
    mtime0 = os.stat(csv0).st_mtime_ns
    os.remove(os.path.join(b, "non_ground_point_cloud", "000003.pcd"))
    os.remove(os.path.join(b, "output_bvm", "000003.png"))
    assert bcm_cli.main([b, "--batch_size=3", "--resume", "--device=cpu"]) == 0
    log = capsys.readouterr().out
    assert "Converting file: 000003" in log and log.count("Converting file") == 1
    assert os.stat(csv0).st_mtime_ns == mtime0
    assert tree_files(a) == tree_files(b)

    assert bcm_cli.main([b, "--device=cpu"]) == 0
    assert os.stat(csv0).st_mtime_ns > mtime0 and tree_files(a) == tree_files(b)


# --- cloud_manip end to end -------------------------------------------------------


def _scan(tmp_path, n: int = 400, seed: int = 1) -> str:
    rng = np.random.default_rng(seed)
    pts = {
        "x": rng.uniform(-90, 90, n).astype(np.float32),
        "y": rng.uniform(-90, 90, n).astype(np.float32),
        "z": rng.uniform(-2.5, 5, n).astype(np.float32),
        "intensity": rng.random(n).astype(np.float32),
        "row": rng.integers(0, 64, n).astype(np.uint16),
        "col": rng.integers(0, 2083, n).astype(np.uint16),
        "t": rng.integers(0, 2**32, n).astype(np.uint32),
        "label": rng.integers(-2, 3, n).astype(np.int16),
    }
    pts["x"][:20] = np.arange(20, dtype=np.float32) - np.float32(10.5)  # cell edges
    os.makedirs(tmp_path, exist_ok=True)
    path = str(tmp_path / "scan.pcd")
    write_pcd(path, pts)
    return path


def _outputs(d) -> dict[str, bytes]:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))
            if n != "scan.pcd"}


@pytest.mark.parametrize("view", ["top", "front"])
def test_cloud_manip_files_byte_equal_to_pctpu(tmp_path, view):
    """The six files, the snapshot in either view and the HTML viewer are
    pctpu's byte for byte; the BEVs are returned as pctpu returns them."""
    a, b = tmp_path / "pctpu", tmp_path / "port"
    outs = []
    for d, run, kw in ((a, jrun_cloud_manip, {}), (b, run_cloud_manip, {"device": "cpu"})):
        pcd = _scan(d)
        outs.append(run(pcd, 1.0, 2.0, 0.0, 30.0, output_dir=str(d),
                        snapshot=str(d / "snap.png"), snapshot_view=view,
                        html=str(d / "scene.html"), **kw))
    fa, fb = _outputs(a), _outputs(b)
    assert sorted(fa) == ["scan.pcd_input.csv", "scan.pcd_input.csv.png", "scan.pcd_input.pcd",
                          "scan.pcd_output.csv", "scan.pcd_output.csv.png",
                          "scan.pcd_output.pcd", "scene.html", "snap.png"]
    assert fa == fb
    for k in ("input", "output"):
        assert np.array_equal(bits(outs[1][k]), bits(outs[0][k]))


@pytest.mark.parametrize("args", [["5", "-3", "0.5", "-117.3"], ["0", "0", "0", "0"]])
def test_cloud_manip_cli_equal_to_pctpu(tmp_path, capsys, args):
    """pctpu's argv (``--output_dir``, ``--snapshot``, ``--html``) plus
    ``--device``: the same ``rotating yaw radiance:`` line and files."""
    a, b = tmp_path / "pctpu", tmp_path / "port"
    logs = []
    for d, main, extra in ((a, jcm_cli.main, []), (b, cm_cli.main, ["--device=cpu"])):
        pcd = _scan(d, seed=3)
        assert main([pcd, *args, f"--output_dir={d}", f"--snapshot={d / 's.png'}",
                     f"--html={d / 'v.html'}", *extra]) == 0
        logs.append(capsys.readouterr().out.splitlines())
    radiance = f"rotating yaw radiance: {float(args[3]) / 180.0 * math.pi}"
    assert radiance in logs[0] and radiance in logs[1]
    assert _outputs(a) == _outputs(b)


@pytest.mark.parametrize("name,argv", [("batch_cloud_manip", []),
                                       ("cloud_manip", ["a.pcd", "1", "2", "3"])])
def test_cli_usage_exit(name, argv, capsys):
    cli = bcm_cli if name == "batch_cloud_manip" else cm_cli
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 1 and "Usage: " + name in capsys.readouterr().out


def test_float_bev_config_equal_to_pctpu():
    for kw in ({}, {"filter_ground": False}, {"max_range": 50.0, "interval": 0.5}):
        got, want = FloatBevConfig(**kw), JFloatBevConfig(**kw)
        assert got.mat_size == want.mat_size and got.__dict__ == want.__dict__
    assert FloatBevConfig().mat_size == 201

