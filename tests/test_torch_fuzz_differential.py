"""The seed-sweep differential of pctpu's ``tests/test_fuzz_differential.py``
through the port: ordering → ground marking → fused multi/single BEV on the
CPU against the plain-loop oracle and against pctpu, across the point
regimes, on the real sensors' full grids, and the registration prep ops.
Every output must be bit-equal to both (voxel centroids within 1e-5 of
the oracle, the top part equal to it as a set, and both bit-equal to
pctpu).  Also: the campaign's scene copies draw pctpu's scenes."""

import numpy as np
import pytest
import torch

import pctpu.cloud as jcloud
from pctpu.config import get_sensor_params as jget_sensor_params
from pctpu.ops.bev import fused_multi_single_bev as jfused
from pctpu.ops.ground import mark_ground as jmark_ground
from pctpu.ops.ordering import get_ordered_cloud as jget_ordered_cloud
from pctpu.ops.topflatten import extract_top_and_flatten as jtop
from pctpu.ops.voxel import voxel_downsample as jvoxel
from pctpu_torch.config import get_sensor_params
from pctpu_torch.experiments import fuzz_campaign as fc
from pctpu_torch.experiments import fuzz_scenes as fs

from . import ref_impl
from . import test_fuzz_differential as jfuzz
from . import test_icp_differential as jicp
from . import test_ops_preprocess as jpre
from . import test_ops_registration as jreg
from scripts import fuzz_campaign as jcampaign

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pctpu_preprocess(points, jparams):
    ordered = jget_ordered_cloud(jpre.to_cloud(points), jparams)
    labeled, _ = jmark_ground(ordered, jparams)
    fm, fsingle = jfused(labeled, jparams.height_res)
    return {"xyz": np.asarray(ordered.xyz), "labels": np.asarray(labeled.label),
            "multi": np.asarray(fm), "single": np.asarray(fsingle)}


def assert_preprocess_three_ways(points, params, jparams, what):
    """The port = the oracle = pctpu, bit for bit."""
    port = fc.port_preprocess(fs.point_arrays(points), params, CPU)
    want = fc.python_oracle(ref_impl, points, params)
    got_j = _pctpu_preprocess(points, jparams)
    for k in ("xyz", "labels", "multi", "single"):
        np.testing.assert_array_equal(port[k], want[k], err_msg=f"{k} vs the oracle ({what})")
        np.testing.assert_array_equal(port[k], got_j[k], err_msg=f"{k} vs pctpu ({what})")


@pytest.mark.parametrize("regime", range(len(fs.REGIMES)))
def test_regime_scene_is_pctpu_s(regime):
    for seed in (0, 7):
        args = fs.REGIMES[regime]
        a = fs.regime_points(np.random.default_rng(seed), *args, fs.SMALL)
        b = jfuzz._regime_points(np.random.default_rng(seed), *args, jpre.SMALL)
        assert a == b


def test_other_scene_copies_are_pctpu_s():
    assert fs.REGIMES == jfuzz.REGIMES
    assert fs.scene_cloud(np.random.default_rng(3)) == jreg.scene_cloud(np.random.default_rng(3))
    for a, b in zip(fs.icp_scene(5, yaw_deg=3.0), jicp.scene(5, yaw_deg=3.0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(fs.plane_scene(6, 2.5, (0.1, 0.2, 0.0)),
                    jicp._plane_scene(6, 2.5, (0.1, 0.2, 0.0))):
        np.testing.assert_array_equal(a, b)
    for seed in (1300004, 1300047, 12):
        for a, b in zip(fs.normals_scene(seed), jcampaign.normals_scene(seed)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("regime", range(len(fs.REGIMES)))
def test_one_seed_per_regime_matches_oracle_and_pctpu(regime):
    """The fast subset: seed 0 of each regime, three ways."""
    pts = fs.regime_points(np.random.default_rng(1000 * regime), *fs.REGIMES[regime], fs.SMALL)
    assert_preprocess_three_ways(pts, fs.SMALL, jpre.SMALL, f"regime {regime}")


@pytest.mark.slow
@pytest.mark.parametrize("regime", range(len(fs.REGIMES)))
def test_fuzz_preprocess_matches_oracle(regime):
    for seed in range(8):
        rng = np.random.default_rng(1000 * regime + seed)
        pts = fs.regime_points(rng, *fs.REGIMES[regime], fs.SMALL)
        assert_preprocess_three_ways(pts, fs.SMALL, jpre.SMALL, f"regime {regime}, seed {seed}")


@pytest.mark.slow
def test_fuzz_all_sensor_presets_one_seed():
    """The oracle sweep once per real sensor at its full grid."""
    for i, sensor in enumerate(("HDL_32E", "HDL_64E", "OS1_64")):
        params = get_sensor_params(sensor)
        pts = fs.regime_points(np.random.default_rng(7000 + i), 600, 0.15, -2.5, 4.0, 2.0, 90.0,
                               params)
        assert_preprocess_three_ways(pts, params, jget_sensor_params(sensor), sensor)


def _prep_ops_three_ways(seed):
    rng = np.random.default_rng(300 + seed)
    pts = rng.uniform(-60, 60, (700, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 10, 700).astype(np.float32)
    ref = ref_impl.voxel_ref(pts, 0.2)
    out, _, count = (t.numpy() for t in fc.voxel_downsample(
        torch.from_numpy(pts), torch.ones(700, dtype=torch.bool), 0.2))
    jout, _, jcount = jvoxel(pts, np.ones(700, bool), 0.2)
    assert int(count) == len(ref) == int(jcount), seed
    np.testing.assert_allclose(out[: int(count)], ref, atol=1e-5, err_msg=str(seed))
    np.testing.assert_array_equal(out, np.asarray(jout), err_msg=str(seed))

    scene = fs.scene_cloud(rng)
    ref_flat = np.asarray(ref_impl.top_flatten_ref(scene), np.float32).reshape(-1, 3)
    got, cnt, full, mask = fc._top_flatten(*fs.xyz_labels(scene), CPU)
    assert cnt == len(ref_flat), seed
    np.testing.assert_array_equal(fc._lexsorted(got), fc._lexsorted(ref_flat), err_msg=str(seed))
    jxyz, jmask, _ = jtop(jreg.to_cloud(scene, capacity=1024))
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    np.testing.assert_array_equal(full, np.asarray(jxyz), err_msg=str(seed))


def test_voxel_topflatten_one_seed():
    _prep_ops_three_ways(0)


@pytest.mark.slow
def test_fuzz_voxel_topflatten_sweep():
    for seed in range(8):
        _prep_ops_three_ways(seed)


@pytest.mark.parametrize("shape", range(4))
def test_campaign_adversarial_shape_matches_oracle_and_pctpu(shape):
    """The campaign's adversarial leg, one case a shape: the port on the
    host-compacted cloud = the oracle on the full list = pctpu on its own
    compaction."""
    from pctpu.ops.ordering import compact_last_wins as jcompact

    seed = 700_000 + shape
    pts = fs.adversarial_points(seed, shape)
    arrays = fs.point_arrays(pts)
    compacted, n_keep = fc.compact_last_wins(arrays, len(pts), fs.SMALL)
    jcompacted, jn_keep = jcompact(arrays, len(pts), jpre.SMALL)
    assert n_keep == jn_keep <= fs.SMALL.grid_size
    for k in arrays:
        np.testing.assert_array_equal(compacted[k], jcompacted[k])
    g = fs.SMALL.grid_size
    port = fc.port_preprocess(compacted, fs.SMALL, CPU, capacity=g)
    want = fc.python_oracle(ref_impl, pts, fs.SMALL)
    jc = jcloud.make_cloud(np.stack([compacted[c] for c in "xyz"], 1),
                           intensity=compacted["intensity"], row=compacted["row"],
                           col=compacted["col"], t=compacted["t"].astype(np.uint32),
                           label=compacted["label"], capacity=g)
    jordered = jget_ordered_cloud(jc, jpre.SMALL)
    jlabeled, _ = jmark_ground(jordered, jpre.SMALL)
    jm, js = jfused(jlabeled, jpre.SMALL.height_res)
    for k, jv in (("xyz", jordered.xyz), ("labels", jlabeled.label), ("multi", jm),
                  ("single", js)):
        np.testing.assert_array_equal(port[k], want[k], err_msg=f"{k} vs the oracle")
        np.testing.assert_array_equal(port[k], np.asarray(jv), err_msg=f"{k} vs pctpu")
