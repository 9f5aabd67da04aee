"""The guard, raise and fall-through branches of pctpu_torch against
pctpu's, on the CPU: one counterpart for each of the 26 cases of
``tests/test_error_branches.py`` (config validation, cloud helpers, loader
edge contracts, the non-default preprocess and 1-NN branches).

Each port branch raises where pctpu's raises (the same exception type and
message, unless a case says otherwise) and falls through where pctpu's
does, with equal results on the same inputs.  The two cases that name JAX
machinery become the port's: ``nn_1_jit`` (pctpu's jit wrapper of
``nn_1``) becomes ``knn.nn_1`` and the pruned kernels' CPU twin against
pctpu's ``nn_1`` and ``nn_1_jit``; the Pallas kernel's argument check
becomes the argument checks of ``ops.cuda_knn`` on CPU tensors."""

import os

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


def _raises_like(exc, match, *calls):
    """Every call raises ``exc`` with a message matching ``match``."""
    for call in calls:
        with pytest.raises(exc, match=match):
            call()


def test_parse_sensor_type_unknown_raises():
    from pctpu.config import parse_sensor_type as jparse
    from pctpu_torch.config import parse_sensor_type

    _raises_like(ValueError, "Unknown sensor type", lambda: jparse("VLP_16"),
                 lambda: parse_sensor_type("VLP_16"))
    for name in ("HDL_64E", "HDL_32E", "OS1_64"):
        assert parse_sensor_type(name).name == jparse(name).name


def test_ground_config_rejects_non_pow2_cell():
    from pctpu.config import GroundConfig as JGroundConfig
    from pctpu_torch.config import GroundConfig

    _raises_like(ValueError, "power of two", lambda: JGroundConfig(cell_size=3.0),
                 lambda: GroundConfig(cell_size=3.0))
    assert GroundConfig(cell_size=4.0).cell_size == JGroundConfig(cell_size=4.0).cell_size


def test_bev_configs_reject_non_pow2_height_scale():
    from pctpu.config import SingleBevConfig as JSingleBevConfig
    from pctpu_torch.config import SingleBevConfig

    _raises_like(ValueError, "power of two", lambda: JSingleBevConfig(height_scale=3.0),
                 lambda: SingleBevConfig(height_scale=3.0))


def test_make_cloud_rejects_bad_shapes():
    from pctpu.cloud import make_cloud as jmake
    from pctpu_torch.cloud import make_cloud

    xyz = np.zeros((5, 3), np.float32)
    _raises_like(ValueError, "exceed capacity", lambda: jmake(xyz, capacity=3),
                 lambda: make_cloud(xyz, capacity=3, device=CPU))
    _raises_like(ValueError, "field length",
                 lambda: jmake(xyz, intensity=np.zeros(4, np.float32)),
                 lambda: make_cloud(xyz, intensity=np.zeros(4, np.float32), device=CPU))


def test_cloud_helpers_round_trip():
    from pctpu.cloud import empty_cloud as jempty
    from pctpu.cloud import make_cloud as jmake
    from pctpu.cloud import stack_clouds as jstack
    from pctpu.cloud import to_numpy as jto_numpy
    from pctpu_torch.cloud import empty_cloud, make_cloud, stack_clouds, to_numpy

    e = empty_cloud(7, device=CPU)
    assert int(e.count) == int(jempty(7).count) == 7 and tuple(e.xyz.shape) == (7, 3)
    assert not torch.any(e.xyz)

    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(6, 3)).astype(np.float32)
    s = stack_clouds([make_cloud(a, capacity=6, device=CPU), make_cloud(b, device=CPU)])
    js = jstack([jmake(a, capacity=6), jmake(b)])
    assert tuple(s.xyz.shape) == (2, 6, 3)
    np.testing.assert_array_equal(s.count.numpy(), np.asarray(js.count))
    np.testing.assert_array_equal(s.xyz.numpy(), np.asarray(js.xyz))

    d, jd = to_numpy(make_cloud(a, capacity=6, device=CPU)), jto_numpy(jmake(a, capacity=6))
    assert d["count"] == jd["count"] == 4 and d["xyz"].shape == (6, 3)
    for key in ("xyz", "intensity", "row", "col", "t", "label"):
        np.testing.assert_array_equal(d[key], np.asarray(jd[key]))
        assert d[key].dtype == np.asarray(jd[key]).dtype


def test_bev_cell_np_matches_torch_twin():
    from pctpu.ops.rounding import bev_cell_np as jbev_cell_np
    from pctpu_torch.ops.rounding import bev_cell, bev_cell_np

    # half-away-from-zero knife edges, negatives and the .5 grid points
    coords = np.array([-112.0, -111.5, -0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 59.49999,
                       59.5, 111.5, 112.0], np.float32)
    got_np = bev_cell_np(coords, 112.0, 1.0)
    np.testing.assert_array_equal(got_np, bev_cell(torch.from_numpy(coords), 112.0, 1.0).numpy())
    np.testing.assert_array_equal(got_np, jbev_cell_np(coords, 112.0, 1.0))


def test_assign_rings_empty_and_negative_start():
    from pctpu.io.kitti import assign_rings as jassign
    from pctpu_torch.io.kitti import assign_rings

    row, col, assigned = assign_rings(np.zeros((0, 4), np.float32))
    assert len(row) == 0 and len(col) == 0 and len(assigned) == 0

    # first azimuth <= 0: the ring starts unassigned (-1) and resets to 0 at
    # the first upward zero crossing
    pts = np.array([[1.0, -0.1, 0.0, 0.0], [1.0, -0.05, 0.0, 0.0], [1.0, 0.1, 0.0, 0.0],
                    [1.0, 0.2, 0.0, 0.0]], np.float32)
    row, col, assigned = assign_rings(pts)
    assert row[0] == -1
    assert not assigned[0] and not assigned[1]
    assert np.all(row[2:] == 0) and np.all(assigned[2:])
    for got, want in zip((row, col, assigned), jassign(pts)):
        np.testing.assert_array_equal(got, want)


def test_read_timestamps_rejects_garbage(tmp_path):
    from pctpu.io.kitti import read_timestamps as jread
    from pctpu_torch.io.kitti import read_timestamps

    p = tmp_path / "times.txt"
    p.write_text("12.75 13.5\n")
    assert read_timestamps(str(p)) == jread(str(p)) == [12, 13]  # std::stoll prefix parse
    p.write_text("abc\n")
    _raises_like(ValueError, "unparseable timestamp", lambda: jread(str(p)),
                 lambda: read_timestamps(str(p)))


def test_icp_sharded_requires_mesh():
    import jax.numpy as jnp

    from pctpu.config import FINE_ICP as JFINE_ICP
    from pctpu.ops.icp import icp as jicp
    from pctpu_torch.config import FINE_ICP
    from pctpu_torch.ops.icp import icp

    pts = torch.zeros((8, 3))
    mask = torch.ones(8, dtype=torch.bool)
    _raises_like(ValueError, "needs a mesh",
                 lambda: jicp(jnp.zeros((8, 3), jnp.float32), jnp.ones((8,), bool),
                              jnp.zeros((8, 3), jnp.float32), jnp.ones((8,), bool), jnp.eye(4),
                              JFINE_ICP, nn_impl="sharded", mesh=None),
                 lambda: icp(pts, mask, pts, mask, torch.eye(4), FINE_ICP, nn_impl="sharded",
                             mesh=None))


def test_sharded_nn_rejects_indivisible_target():
    from pctpu_torch.parallel.mesh import make_mesh, sharded_nn_1

    run = sharded_nn_1(make_mesh(n_data=1, n_points=2, devices=[CPU] * 2))
    q = torch.zeros((4, 3))
    t = torch.zeros((9, 3))  # odd: not divisible by 2 shards
    calls = [lambda: run(q, torch.ones(4, dtype=torch.bool), t, torch.ones(9, dtype=torch.bool))]
    import jax

    if len(jax.devices()) >= 2:
        from pctpu.parallel.mesh import make_mesh as jmesh
        from pctpu.parallel.mesh import sharded_nn_1 as jsharded

        jrun = jsharded(jmesh(n_data=len(jax.devices()) // 2, n_points=2))
        calls.append(lambda: jrun(np.zeros((4, 3), np.float32), np.ones(4, bool),
                                  np.zeros((9, 3), np.float32), np.ones(9, bool)))
    _raises_like(ValueError, "must divide the target", *calls)


def test_distributed_initialize_single_process_is_noop():
    import torch.distributed as dist

    from pctpu_torch.parallel.distributed import initialize, process_count, process_index

    # must not bind a coordinator: one process joins no group
    initialize("localhost:9999", num_processes=1, process_id=0)
    assert not dist.is_initialized()
    assert (process_index(), process_count()) == (0, 1)


def test_profiler_trace_enabled(tmp_path):
    from pctpu_torch.runtime.profiler import trace

    with trace("unit", enabled=True, trace_dir=str(tmp_path)):
        torch.arange(4).sum()
    written = os.listdir(str(tmp_path))
    assert written and any(w.startswith("unit.") for w in written)
    with trace("off", enabled=False, trace_dir=str(tmp_path / "off")):
        torch.arange(4).sum()
    assert not (tmp_path / "off").exists()


def test_preprocess_unfused_branch_matches_ops_and_pctpu():
    """Mismatched BEV grids take the unfused multi_bev + single_bev branch;
    its outputs equal the direct op calls and pctpu's."""
    from pctpu.cloud import make_cloud as jmake
    from pctpu.config import GroundConfig as JG
    from pctpu.config import MultiBevConfig as JM
    from pctpu.config import SensorParams as JSP
    from pctpu.config import SingleBevConfig as JS
    from pctpu.ops.preprocess import preprocess_cloud as jpre
    from pctpu_torch.cloud import make_cloud
    from pctpu_torch.config import GroundConfig, MultiBevConfig, SensorParams, SingleBevConfig
    from pctpu_torch.ops.bev import fused_bev_compatible, multi_bev, single_bev
    from pctpu_torch.ops.preprocess import preprocess_cloud

    shape = dict(n_scan=8, horizon_scan=32, ground_upper_scan=6, height_res=0.5)
    params = SensorParams(**shape)
    single_cfg = SingleBevConfig(max_range=100.0)  # a 201-px grid against multi's 225
    multi_cfg = MultiBevConfig()
    assert not fused_bev_compatible(multi_cfg, single_cfg)

    rng = np.random.default_rng(2)
    n = 120
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-2.2, 3.0, n).astype(np.float32)
    fields = dict(row=rng.integers(0, params.n_scan, n).astype(np.int32),
                  col=rng.integers(0, params.horizon_scan, n).astype(np.int32),
                  label=np.full(n, -2, np.int32), capacity=params.grid_size)
    labeled, multi_img, single_img = preprocess_cloud(
        make_cloud(xyz, device=CPU, **fields), params, GroundConfig(), multi_cfg, single_cfg)
    np.testing.assert_array_equal(multi_img.numpy(),
                                  multi_bev(labeled, params.height_res, multi_cfg).numpy())
    np.testing.assert_array_equal(single_img.numpy(), single_bev(labeled, single_cfg).numpy())
    jl, jm, js = jpre(jmake(xyz, **fields), JSP(**shape), JG(), JM(), JS(max_range=100.0))
    np.testing.assert_array_equal(multi_img.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(single_img.numpy(), np.asarray(js))
    np.testing.assert_array_equal(labeled.label.numpy(), np.asarray(jl.label))


def test_cli_common_flag_parse_errors(capsys):
    from pctpu.cli import _common as jcommon
    from pctpu_torch.cli._common import int_kw, path_kw

    for mod_int, mod_path in ((int_kw, path_kw), (jcommon.int_kw, jcommon.path_kw)):
        assert mod_int({"n": "4"}, "n", 1) == 4
        with pytest.raises(SystemExit):
            mod_int({"pair_batch": "two"}, "pair_batch", 1)
        assert mod_path({}, "report") is None
        assert mod_path({"report": "true"}, "report", default="/tmp/r.txt") == "/tmp/r.txt"
        assert mod_path({"report": "x.txt"}, "report") == "x.txt"
        with pytest.raises(SystemExit):
            mod_path({"report": ""}, "report")
    capsys.readouterr()


def test_pcd_header_and_mode_errors(tmp_path):
    from pctpu.io import pcd as jpcd
    from pctpu_torch.io.pcd import FieldSpec, read_pcd, read_pcd_point_count, write_pcd

    fx = (FieldSpec("x", np.float32, 1),)
    jfx = (jpcd.FieldSpec("x", np.float32, 1),)
    _raises_like(ValueError, "width\\*height",
                 lambda: write_pcd(str(tmp_path / "bad.pcd"), {"x": np.zeros(5, np.float32)},
                                   fields=fx, width=2, height=2),
                 lambda: jpcd.write_pcd(str(tmp_path / "jbad.pcd"),
                                        {"x": np.zeros(5, np.float32)}, fields=jfx, width=2,
                                        height=2))

    p = tmp_path / "noheader.pcd"
    p.write_bytes(b"VERSION 0.7\nDATA binary\n")
    _raises_like(ValueError, "no POINTS line", lambda: read_pcd_point_count(str(p)),
                 lambda: jpcd.read_pcd_point_count(str(p)))

    good = tmp_path / "ok.pcd"
    write_pcd(str(good), {"x": np.arange(3, dtype=np.float32)}, fields=fx)
    jgood = tmp_path / "jok.pcd"
    jpcd.write_pcd(str(jgood), {"x": np.arange(3, dtype=np.float32)}, fields=jfx)
    assert good.read_bytes() == jgood.read_bytes()
    bad = tmp_path / "mode.pcd"
    bad.write_bytes(good.read_bytes().replace(b"DATA binary", b"DATA base85"))
    _raises_like(ValueError, "unsupported PCD DATA mode", lambda: read_pcd(str(bad)),
                 lambda: jpcd.read_pcd(str(bad)))


def test_load_cloud_pcd_plain_xyz_defaults(tmp_path):
    from pctpu.io.pcd import load_cloud_pcd as jload
    from pctpu_torch.io.pcd import FieldSpec, load_cloud_pcd, write_pcd

    pts = np.arange(9, dtype=np.float32).reshape(3, 3)
    fxyz = tuple(FieldSpec(n, np.float32, 1) for n in ("x", "y", "z"))
    path = str(tmp_path / "xyz.pcd")
    write_pcd(path, {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2]}, fields=fxyz)
    c = load_cloud_pcd(path, capacity=5, device=CPU)
    assert int(c.count) == 3 and tuple(c.xyz.shape) == (5, 3)
    np.testing.assert_array_equal(c.xyz.numpy()[:3], pts)
    assert not torch.any(c.intensity) and not torch.any(c.label)  # missing fields are zero
    jc = jload(path, capacity=5)
    for f in ("xyz", "intensity", "row", "col", "label"):
        np.testing.assert_array_equal(getattr(c, f).numpy(), np.asarray(getattr(jc, f)))


def test_png_shape_and_format_errors():
    from pctpu.io import png as jpng
    from pctpu_torch.io.png import decode_gray_png, encode_gray_png, encode_rgb_png

    for enc_gray, enc_rgb, dec_gray in ((encode_gray_png, encode_rgb_png, decode_gray_png),
                                        (jpng.encode_gray_png, jpng.encode_rgb_png,
                                         jpng.decode_gray_png)):
        _raises_like(ValueError, "2-D image", lambda: enc_gray(np.zeros((2, 2, 3), np.uint8)))
        _raises_like(ValueError, r"\(H, W, 3\) uint8", lambda: enc_rgb(np.zeros((2, 2), np.uint8)))
        _raises_like(ValueError, "not a PNG", lambda: dec_gray(b"JFIF....definitely-not-png"))
        rgb = enc_rgb(np.zeros((2, 2, 3), np.uint8))
        _raises_like(ValueError, "color type", lambda: dec_gray(rgb))
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert encode_gray_png(img) == jpng.encode_gray_png(img)


def test_csvfmt_dtype_branches():
    from pctpu.io import csvfmt as jcsv
    from pctpu_torch.io.csvfmt import format_csv, format_csv_bytes

    for fmt in (format_csv, jcsv.format_csv):
        _raises_like(ValueError, "2-D matrix", lambda: fmt(np.zeros(3, np.float32)))
        _raises_like(TypeError, "unsupported dtype", lambda: fmt(np.zeros((2, 2), np.complex64)))
    m16 = np.array([[-3, 40000 - 65536]], np.int16)
    assert format_csv(m16) == jcsv.format_csv(m16) == "-3, -25536"
    m = np.array([[np.nan, -np.nan, 1.5]], np.float32)
    assert format_csv_bytes(m) == jcsv.format_csv_bytes(m) == b"nan, -nan, 1.5"


def test_ground_rejects_too_high_ground_rows():
    from pctpu.cloud import empty_cloud as jempty
    from pctpu.config import GroundConfig as JG
    from pctpu.config import SensorParams as JSP
    from pctpu.ops.ground import mark_ground as jmark
    from pctpu_torch.cloud import empty_cloud
    from pctpu_torch.config import GroundConfig, SensorParams
    from pctpu_torch.ops.ground import mark_ground

    shape = dict(n_scan=8, horizon_scan=16, ground_upper_scan=7, height_res=0.5)
    params = SensorParams(**shape)
    _raises_like(ValueError, "at least two rows above",
                 lambda: mark_ground(empty_cloud(params.grid_size, device=CPU), params,
                                     GroundConfig()),
                 lambda: jmark(jempty(params.grid_size), JSP(**shape), JG()))


def test_fused_bev_rejects_incompatible_configs():
    """pctpu asserts (AssertionError); the port raises ValueError with the
    same words, which ``python -O`` cannot strip."""
    from pctpu.cloud import empty_cloud as jempty
    from pctpu.config import MultiBevConfig as JM
    from pctpu.config import SingleBevConfig as JS
    from pctpu.ops.bev import fused_multi_single_bev as jfused
    from pctpu_torch.cloud import empty_cloud
    from pctpu_torch.config import MultiBevConfig, SingleBevConfig
    from pctpu_torch.ops.bev import fused_multi_single_bev

    _raises_like(AssertionError, "matching multi/single",
                 lambda: jfused(jempty(16), 0.25, JM(), JS(max_range=100.0)))
    _raises_like(ValueError, "matching multi/single",
                 lambda: fused_multi_single_bev(empty_cloud(16, device=CPU), 0.25,
                                                MultiBevConfig(), SingleBevConfig(max_range=100.0)))


def test_nn_1_and_pruned_twin_match_pctpu_nn_1_and_jit():
    """pctpu's ``nn_1_jit`` wrapper equals its ``nn_1``; the port's
    ``knn.nn_1`` and the pruned kernels' CPU twin equal both."""
    from pctpu.ops.knn import nn_1 as jnn_1
    from pctpu.ops.knn import nn_1_jit
    from pctpu_torch.ops import cuda_knn
    from pctpu_torch.ops.knn import nn_1

    rng = np.random.default_rng(6)
    q = rng.normal(size=(40, 3)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    qm, tm = np.ones(40, bool), np.ones(64, bool)
    i1, d1 = jnn_1(q, qm, t, tm)
    i2, d2 = nn_1_jit(q, qm, t, tm)
    i3, d3 = nn_1(*(torch.from_numpy(a) for a in (q, qm, t, tm)))
    i4, d4 = cuda_knn.nn_1_pruned(*(torch.from_numpy(a) for a in (q, qm, t, tm)))
    for idx, dist in ((i2, d2), (i3, d3), (i4, d4)):
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(i1))
        np.testing.assert_array_equal(np.asarray(dist).view(np.uint32),
                                      np.asarray(d1).view(np.uint32))


def test_select_major_frames_empty():
    from pctpu.ops.select import select_major_frames as jselect
    from pctpu_torch.ops.select import select_major_frames

    assert select_major_frames(np.zeros((0, 3), np.float32)) == []
    assert jselect(np.zeros((0, 3), np.float32)) == []


def test_render_unknown_view_raises():
    from pctpu.ops import render as jrender
    from pctpu_torch.ops.render import Layer, render_snapshot

    _raises_like(ValueError, "unknown view",
                 lambda: render_snapshot([Layer(xyz=np.zeros((4, 3), np.float32),
                                                color=(255, 0, 0))], img_size=64,
                                         view="isometric"),
                 lambda: jrender.render_snapshot([jrender.Layer(
                     xyz=np.zeros((4, 3), np.float32), color=(255, 0, 0))], img_size=64,
                     view="isometric"))


def test_cuda_knn_argument_checks_on_cpu_tensors():
    """The counterpart of the Pallas kernel's argument check: a variant that
    was not compiled, a pass with no target, and the kernels' launchers,
    which take CUDA tensors only, all raise on CPU tensors (a CPU tensor
    reaches a kernel only through a wrapper, which runs its twin)."""
    from pctpu.ops.pallas_knn import pallas_nn_1_pruned
    from pctpu_torch.ops import cuda_knn

    q = torch.zeros((8, 3))
    t = torch.zeros((8, 3))
    qm = tm = torch.ones(8, dtype=torch.bool)
    _raises_like(ValueError, "kernel must be",
                 lambda: pallas_nn_1_pruned(np.zeros((8, 3), np.float32), np.ones(8, bool),
                                            np.zeros((8, 3), np.float32), np.ones(8, bool),
                                            interpret=True, kernel="bogus"))
    _raises_like(ValueError, "is not", lambda: cuda_knn.nn_1_pruned_variant(
        q, qm, t, tm, None, 256, 1024, "bogus"))
    _raises_like(ValueError, "give target and target_mask",
                 lambda: cuda_knn.nn_1_pruned(q, qm))
    _raises_like(ValueError, "needs? CUDA tensors",
                 lambda: cuda_knn._pass_launcher(q, qm, cuda_knn.prepare_target(t, tm),
                                                 float("inf")),
                 lambda: cuda_knn._variant_launcher(
                     q, qm, cuda_knn.prepare_variant_target(t, tm, 1024), t, float("inf"),
                     256, 1024, "prod"))
    _raises_like(ValueError, "needs CUDA tensors",
                 lambda: cuda_knn._fused_launcher(q, qm, t, tm))


def test_logging_helpers_print(capsys):
    from pctpu.utils import logging as jlog
    from pctpu_torch.utils import logging as log

    log.red("failure text")
    log.error("error text")
    out = capsys.readouterr()
    jlog.red("failure text")
    jlog.error("error text")
    jout = capsys.readouterr()
    assert "failure text" in out.out and "error text" in out.out + out.err
    assert (out.out, out.err) == (jout.out, jout.err)


def test_reset_dir_clears_unless_resume(tmp_path):
    from pctpu_torch.pipelines.multi_bev import _reset_dir

    d = tmp_path / "out"
    d.mkdir()
    (d / "stale.bin").write_bytes(b"x")
    _reset_dir(str(d), resume=True)
    assert (d / "stale.bin").exists()
    _reset_dir(str(d), resume=False)
    assert d.is_dir() and not list(d.iterdir())
    _reset_dir(str(tmp_path / "fresh" / "deep"), resume=True)
    assert (tmp_path / "fresh" / "deep").is_dir()
