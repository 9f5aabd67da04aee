"""pctpu's tools outside the package, ported into ``pctpu_torch.experiments``,
against pctpu on the CPU: the reference-parity harness
(``scripts/run_reference_parity.py``), the registration chain's device floor
(``scripts/probe_registration_floor.py``), the scaling harness
(``scripts/run_scaling_bench.py``) and the sort-ordering experiment
(``scripts/exp_sort_ordering.py``); and the long-segment tail of the
in-order segment sums' twin (ROADMAP F11), which these tools' CPU runs
first met."""

import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pctpu_torch.experiments import reference_parity as rp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _script(name: str):
    """pctpu's ``scripts/<name>.py`` as a module (it is no package)."""
    spec = importlib.util.spec_from_file_location(f"pctpu_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the reference-parity harness ---------------------------------------------


def test_parity_harness_falls_back_without_pcl(tmp_path):
    """Given a reference checkout but no PCL, the harness says why and falls
    back to the native-oracle tier, whose every artifact comparison agrees;
    the verdict JSON has pctpu's keys and the device."""
    verdict = tmp_path / "verdict.json"
    (tmp_path / "reference").mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", PCTPU_REFERENCE=str(tmp_path / "reference"))
    r = subprocess.run([sys.executable, "-m", "pctpu_torch.experiments.reference_parity",
                        "--device=cpu", f"--json={verdict}"], capture_output=True, text=True,
                       cwd=REPO, timeout=600, env=env)
    if "reference submodule" in r.stdout:  # a machine with PCL tried the empty checkout
        return
    assert r.returncode == 0, r.stderr[-2000:]
    assert "reference build prerequisites missing" in r.stdout
    assert "native-oracle tier report" in r.stdout and "0 diverging" in r.stdout
    got = json.loads(verdict.read_text())
    assert set(got) == {"tier", "comparisons", "outside_window", "accepted",
                        "acceptance_window", "lines", "device"}
    assert (got["tier"], got["comparisons"], got["outside_window"], got["accepted"]) == \
        ("native-oracle", 15, 0, True)
    assert got["device"] == {"type": "cpu"}


def test_native_oracle_tier_matches_pctpu(tmp_path, monkeypatch):
    """The port's native-oracle tier on the CPU gives pctpu's verdict: the
    same tier, the same comparisons line for line, 0 diverging; its CLIs run
    through the ``cli`` it is given."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    jrp = _script("run_reference_parity")
    (tmp_path / "port").mkdir()
    (tmp_path / "pctpu").mkdir()
    ran = []

    def cli(tool, *args, device):
        ran.append((tool, device))
        rp.port_cli(tool, *args, device=device)

    got = rp.native_oracle_tier(str(tmp_path / "port"), "cpu",
                                json_path=str(tmp_path / "port.json"), cli=cli)
    assert ran == [("kitti_point_cloud_select", "cpu"), ("batch_multi_bev_gen", "cpu")]
    assert jrp.native_oracle_tier(str(tmp_path / "pctpu"),
                                  json_path=str(tmp_path / "pctpu.json")) == 0
    want = json.loads((tmp_path / "pctpu.json").read_text())
    assert got["tier"] == want["tier"] == "native-oracle"
    assert got["lines"] == want["lines"]
    assert got["comparisons"] == want["comparisons"] == 15
    assert got["outside_window"] == want["outside_window"] == 0


def test_reference_tier_skipped_without_the_variable(monkeypatch, tmp_path, capsys):
    """The reference is taken from ``PCTPU_REFERENCE`` only: unset, the
    reference tier is skipped even where every prerequisite is present —
    nothing is probed or built — and the native-oracle tier runs."""
    monkeypatch.delenv("PCTPU_REFERENCE", raising=False)

    def refused(*args, **kw):
        raise AssertionError("the reference tier ran without PCTPU_REFERENCE")

    tiers = []

    def native(workdir, device, json_path=None):
        tiers.append((workdir, device))
        return {"outside_window": 0}

    monkeypatch.setattr(rp, "check_deps", refused)
    monkeypatch.setattr(rp, "build_reference", refused)
    monkeypatch.setattr(rp, "reference_tier", refused)
    monkeypatch.setattr(rp, "native_oracle_tier", native)
    assert rp.main(["--device=cpu", f"--workdir={tmp_path}", "--build-reference"]) == 0
    assert tiers == [(str(tmp_path), "cpu")]
    assert "PCTPU_REFERENCE is not set: the reference tier is skipped" in capsys.readouterr().out


def test_check_deps_without_cmake(monkeypatch, tmp_path):
    """With no cmake on the PATH the port reports it missing (and the
    harness falls back); pctpu's probe runs cmake anyway and raises
    (ROADMAP F12, pctpu not changed)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert rp.check_deps() == ["cmake"]
    with pytest.raises(FileNotFoundError):
        _script("run_reference_parity").check_deps()


def test_kitti_tree_bytes_equal_pctpu_fixture(tmp_path):
    from tests.fixtures import make_kitti_tree

    rp.make_kitti_tree(str(tmp_path / "port"), num_frames=5, spacing=3.0)
    make_kitti_tree(str(tmp_path / "pctpu"), num_frames=5, spacing=3.0)
    cmp = filecmp.dircmp(str(tmp_path / "port"), str(tmp_path / "pctpu"))
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    names = sorted(os.listdir(tmp_path / "port" / "velodyne"))
    assert len(names) == 5
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / "velodyne" / n,
                           tmp_path / "pctpu" / "velodyne" / n, shallow=False)


def _bev_trees(root):
    """Two small trees of BEV artifacts that differ in chosen ways."""
    from pctpu_torch.io.png import encode_gray_png

    a, b = root / "ref", root / "got"
    for d in (a, b):
        (d / "image").mkdir(parents=True)
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    (a / "image" / "same.png").write_bytes(encode_gray_png(img))
    (b / "image" / "same.png").write_bytes(encode_gray_png(img))
    off = img.copy()
    off[1, 2] += 1
    (a / "image" / "px.png").write_bytes(encode_gray_png(img))
    (b / "image" / "px.png").write_bytes(encode_gray_png(off))
    (a / "x.csv").write_text("1, 2\n3, 4\n")
    (b / "x.csv").write_text("1, 2.5\n3, 4\n")
    (a / "y.csv").write_text("1, 2\n")
    (b / "y.csv").write_text("1, 2, 3\n")
    (a / "gone.bin").write_bytes(b"\x00")
    (a / "z.bin").write_bytes(b"\x00\x01")
    (b / "z.bin").write_bytes(b"\x00\x02")
    (a / "bad.png").write_bytes(b"junk")
    (b / "bad.png").write_bytes(b"junk2")
    return str(a), str(b)


def test_diff_trees_and_registration_lines_match_pctpu(tmp_path):
    """The comparison lines equal pctpu's, but for differing PNGs: pctpu
    decodes them with ``tests.test_png.read_gray_png``, which does not
    exist, so each is a PX-ERR outside the window however close (ROADMAP
    F12, pctpu not changed); the port decodes them (``io.png``)."""
    jrp = _script("run_reference_parity")
    a, b = _bev_trees(tmp_path)
    got, want = [], []
    rp.diff_trees(a, b, "t", got)
    jrp.diff_trees(a, b, "t", want)
    pngs = {"t/image/px.png", "t/bad.png"}

    def others(lines):
        return sorted(line for line in lines if next(
            tok for tok in line.split() if tok.startswith("t/")).rstrip(":") not in pngs)

    assert others(got) == others(want)
    assert "PX-DIFF max=1 n=1 t/image/px.png" in got
    assert any(g.startswith("PX-ERR   t/bad.png: not a PNG") for g in got)
    assert sorted(w.split(":")[0] for w in want if "read_gray_png" in w) == \
        ["PX-ERR   t/bad.png", "PX-ERR   t/image/px.png"]
    # MISSING, BYTES-DIFF, the CSV shapes and the junk PNG; 1 px is inside
    assert rp.count_bad(got) == 4

    for ref, port in (("0.5 1.0\n0.25 -0.5\n", "0.5 1.2\n0.3 -0.5\n"),
                      ("0.5 1.0\n", "0.5 1.7\n"), ("0.5 1.0\n", "x y\n"),
                      ("0.5 1.0\n0.2 0.1\n", "0.5 1.0\n"), ("", "")):
        (tmp_path / "r.txt").write_text(ref)
        (tmp_path / "p.txt").write_text(port)
        got, want = [], []
        rp.parity_registration(str(tmp_path / "r.txt"), str(tmp_path / "p.txt"), got)
        jrp.parity_registration(str(tmp_path / "r.txt"), str(tmp_path / "p.txt"), want)
        assert [g.replace("(port)", "(pctpu)") for g in got] == want


def test_tools_exit_2_without_a_card(monkeypatch, capsys):
    """``--device=cuda`` (the default) without a card exits 2 with a message
    naming ``--device=cpu``; nothing falls back to the CPU."""
    from pctpu_torch.experiments import registration_floor, scaling_bench, sort_ordering

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (rp.main, registration_floor.main, scaling_bench.main, sort_ordering.main):
        assert main([]) == 2
        assert "--device=cpu" in capsys.readouterr().err


# --- the registration chain's device floor ------------------------------------


def test_profile_window_retakes_an_empty_window(monkeypatch):
    """``card.profile_window`` (the floor's and ``profile_calls``' one
    window): with no device events (the CPU) each of its four windows is
    retaken, and the wall it gives is its span's."""
    import time

    from pctpu_torch.experiments import card

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.002)

    events, wall_ms = card.profile_window(fn, 2)
    assert events == [] and len(calls) == 8
    assert 4.0 <= wall_ms < 1000.0


def test_kernel_names_and_counts_by_one_rule():
    """One naming rule for every device event (``card.kernel_name``), and
    ``card.by_name``'s launches and ms a call."""
    from types import SimpleNamespace

    from pctpu_torch.experiments import card

    names = {
        "void nn_pruned_batched_kernel<128>(float const*, int)": "nn_pruned_batched_kernel",
        "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>(int)":
            "vectorized_elementwise_kernel",
        "void cub::DeviceRadixSortOnesweepKernel<Policy, false>(int*)":
            "DeviceRadixSortOnesweepKernel",
        "void (anonymous namespace)::gemv::kernel<float>(float*)": "gemv::kernel",
        "Memcpy DtoH (Device -> Pinned)": "Memcpy DtoH (Device -> Pinned)",
        "Memset (Device)": "Memset (Device)",
    }
    for raw, short in names.items():
        assert card.kernel_name(raw) == short
    assert [card.is_copy(n) for n in names.values()] == [False] * 4 + [True] * 2
    events = [SimpleNamespace(name=n, device_time_total=t) for n, t in (
        ("void seg_kernel<1>(int)", 10.0), ("void seg_kernel<2>(int)", 30.0),
        ("Memset (Device)", 2.0), ("void seg_kernel<1>(int)", 20.0))]
    counts, ms = card.by_name(events, 2)
    assert counts == {"seg_kernel": 1.5, "Memset (Device)": 0.5}
    assert ms == pytest.approx({"seg_kernel": 0.03, "Memset (Device)": 0.001})


def test_registration_floor_chain_bit_equal_to_register_pairs(one_thread, capsys):
    """2 pairs, 1 timed batch on the CPU (every 15th point of the bench
    scene): the chain at the learned buckets gives ``register_pairs``'s
    transforms bit for bit."""
    from pctpu_torch.experiments import registration_floor

    out = registration_floor.run(["1", "--pairs=2", "--small", "--device=cpu"])
    assert out["register_pairs_bit_equal"] and out["max_abs_err_vs_register_pairs"] == 0.0
    assert (out["n_pairs"], out["n_steps"], out["points"]) == (2, 1, 3400)
    assert (out["bucket_coarse"], out["bucket_fine"]) == (1024, 4096)
    assert np.isfinite(out["checksum"]) and out["ms_per_pair_wall"] > 0
    assert out["ms_per_pair_device_serial"] is None  # no card: no device time
    assert out["device_ms_per_pair_by_kernel"] is None
    assert registration_floor.main(["1", "--pairs=2", "--small", "--device=cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["register_pairs_bit_equal"] is True


def test_registration_floor_scene_is_the_bench_pair():
    """The probe's pairs are bench.py's registration scene: the port's scene
    copy, moved copy and per-pair shift."""
    import bench
    from pctpu_torch.experiments import registration_floor

    pairs = registration_floor.scene_pairs(CPU, 3, 1, 65536)
    c1, c2 = bench.registration_scene()
    for i, (a, b, guess) in enumerate(pairs):
        assert guess == 17.0 and int(a.count) == int(c1.count) == 51000
        np.testing.assert_array_equal(a.xyz.numpy(), np.asarray(c1.xyz + i * 1e-4))
        np.testing.assert_array_equal(b.xyz.numpy(), np.asarray(c2.xyz))
        np.testing.assert_array_equal(a.label.numpy(), np.asarray(c1.label))


# --- the scaling harness ------------------------------------------------------------


def test_scaling_bench_cpu_identity(one_thread, capsys):
    from pctpu_torch.experiments import scaling_bench

    results, summary = scaling_bench.run(["--cpu", "2", "--small", "--registration"])
    assert [r["devices"] for r in results] == [1, 2]
    assert results[1]["outputs_byte_identical_to_single_device"] is True
    assert results[1]["registration_identical_to_single_device"] is True
    assert not any("ERROR" in r for r in results)
    assert (summary["backend"], summary["distinct_devices"], summary["perf_meaningful"]) == \
        ("cpu", 1, False)
    assert "not a scaling claim" in capsys.readouterr().out


def test_scaling_bench_rejects_more_cpu_devices_than_given(capsys):
    from pctpu_torch.experiments import scaling_bench

    assert scaling_bench.main(["--cpu", "2", "--device-counts", "1,4"]) == 1
    assert "only 2 available" in capsys.readouterr().err


def test_scaling_bench_one_rule_picks_the_pool(capsys):
    """``--cpu N`` implies ``--device=cpu`` on N logical devices,
    ``--device=cpu`` alone is one, nothing is the cards; ``--cpu N`` with
    ``--device=cuda`` exits 1."""
    from pctpu_torch.experiments import scaling_bench

    def pool(argv):
        args = scaling_bench.parse(argv)
        return args.device, args.cpu

    assert pool(["--cpu", "2"]) == ("cpu", 2)
    assert pool(["--cpu", "2", "--device=cpu"]) == ("cpu", 2)
    assert pool(["--device=cpu"]) == ("cpu", 1)
    assert pool([]) == ("cuda", 0)
    assert pool(["--device=cuda"]) == ("cuda", 0)
    assert scaling_bench.main(["--cpu", "2", "--device=cuda"]) == 1
    assert "takes no --device=cuda" in capsys.readouterr().err


def test_scaling_scene_and_synth_batch_match_pctpu():
    """The harness's inputs are pctpu's: ``synth_batch`` (bench.py:142) in
    both layouts and the registration scene of run_scaling_bench.py."""
    import bench
    from pctpu.config import get_sensor_params as jparams
    from pctpu_torch.config import get_sensor_params
    from pctpu_torch.experiments import scaling_bench, scene

    for ordered in (False, True):
        want = bench.synth_batch(jparams("HDL_32E"), 2, 30000, 5, ordered=ordered)
        got = scene.synth_batch(get_sensor_params("HDL_32E"), 2, 30000, 5, ordered=ordered,
                                device=CPU)
        for f in ("xyz", "intensity", "row", "col", "label"):
            w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert g.dtype == w.dtype and np.array_equal(g.view(np.uint32), w.view(np.uint32)), f
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t).astype(np.int64))
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    # run_scaling_bench.py:186-206 draws bench.py's registration scene
    xyz, xyz2, lab, cap, flat_cap, per_dev = scaling_bench.registration_scene(small=False)
    assert (len(xyz), cap, flat_cap, per_dev) == (51000, 65536, 32768, 16)
    bc1, bc2 = bench.registration_scene()
    np.testing.assert_array_equal(xyz, np.asarray(bc1.xyz)[:51000])
    np.testing.assert_array_equal(xyz2, np.asarray(bc2.xyz)[:51000])
    np.testing.assert_array_equal(lab, np.asarray(bc1.label)[:51000])


# --- the sort-ordering experiment --------------------------------------------------


def test_sort_variant_bit_equal_to_ordering_and_pctpu():
    """The sort variant equals the port's ``get_ordered_cloud`` and pctpu's
    ``get_ordered_cloud_sort`` bit for bit: duplicate cells (more points
    than cells), out-of-range rows and columns, padding, ±0.0 and NaN."""
    import jax

    from pctpu.cloud import Cloud as JCloud
    from pctpu.config import SensorParams as JSensorParams
    from pctpu_torch.cloud import Cloud
    from pctpu_torch.config import SensorParams
    from pctpu_torch.experiments.sort_ordering import get_ordered_cloud_sort, same_bits
    from pctpu_torch.ops.ordering import get_ordered_cloud

    jsort = _script("exp_sort_ordering").get_ordered_cloud_sort
    shape = dict(n_scan=16, horizon_scan=64, ground_upper_scan=10, height_res=0.5)
    params = SensorParams(**shape)
    rng = np.random.default_rng(4)
    b, p = 3, 1500  # more points than the 1,024 cells
    xyz = rng.normal(0, 20, (b, p, 3)).astype(np.float32)
    xyz[0, :5] = [[0.0, -0.0, np.nan], [-0.0, 0.0, 1.0], [np.inf, 0, 0], [1, 2, 3], [4, 5, 6]]
    row = rng.integers(-2, 18, (b, p)).astype(np.int32)
    col = rng.integers(-3, 67, (b, p)).astype(np.int32)
    arrays = dict(xyz=xyz, intensity=rng.random((b, p)).astype(np.float32), row=row, col=col,
                  t=rng.integers(0, 2**32, (b, p)).astype(np.uint32),
                  label=rng.integers(-2, 3, (b, p)).astype(np.int32),
                  count=np.array([p, 900, 0], np.int32))
    cloud = Cloud(**{k: torch.from_numpy(v.astype(np.int64) if k in ("t", "count") else v)
                     for k, v in arrays.items()})
    got = get_ordered_cloud_sort(cloud, params)
    assert same_bits(got, get_ordered_cloud(cloud, params))
    want = jax.jit(jax.vmap(lambda c: jsort(c, JSensorParams(**shape))))(
        JCloud(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}))
    for f in ("xyz", "intensity", "row", "col", "label"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), f
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t).astype(np.int64))
    # one cloud without a batch axis
    one = Cloud(**{k: getattr(cloud, k)[1] for k in ("xyz", "intensity", "row", "col", "t",
                                                      "label")}, count=900)
    assert same_bits(get_ordered_cloud_sort(one, params), get_ordered_cloud(one, params))


def test_sort_ordering_run_on_hdl64e_cpu(one_thread):
    from pctpu_torch.experiments import sort_ordering

    out = sort_ordering.run(["--device=cpu", "--small"])
    assert out["bit_equal"] is True
    assert (out["clouds"], out["n_points"]) == (2, 119980)
    assert out["ms_per_cloud_segment_max_gather"] > 0 and out["ms_per_cloud_sort_based"] > 0


# --- F11: the segment sums' twin on one long segment --------------------------------


@pytest.mark.parametrize("lanes", [2, 4])
def test_segment_sum_twin_long_segment_adds_in_row_order(lanes):
    """An ordered cloud's empty cells all fall in one ground sector, one
    segment of ~10^5 rows: the twin adds them one by one in row order in
    f32 (numpy's ``add.accumulate`` is sequential), beside short segments
    and rows that join none."""
    from pctpu_torch.ops.voxel import segment_sum_sorted_reference

    rng = np.random.default_rng(lanes)
    short = np.repeat(np.arange(40), rng.integers(1, 12, 40))
    seg = np.concatenate([short, np.full(120_000, 40), [-1, -1, 10**6]]).astype(np.int32)
    vals = (rng.standard_normal((len(seg), lanes)) * 100).astype(np.float32)
    vals[len(short) + 7] = np.nan if lanes == 2 else [np.inf, 0.0, -0.0, 1.0]
    init = tuple(rng.standard_normal(lanes).astype(np.float32).tolist())
    got = segment_sum_sorted_reference(torch.from_numpy(vals), torch.from_numpy(seg), init,
                                       n_out=43).numpy()
    want = np.tile(np.float32(init), (43, 1))
    for s in range(41):
        rows = vals[seg == s]
        want[s] = np.add.accumulate(np.concatenate([want[s][None], rows]), axis=0)[-1]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
