"""The port's differential campaign (``pctpu_torch.experiments.fuzz_campaign``)
on the CPU: it runs every leg clean at a small size, it fails — a ``FAIL
<leg> seed=`` line and exit 1 — when an op is made wrong on purpose, its
card-against-CPU check fails when the two runs differ, its D2 attribution
needs its evidence, it refuses ``--device=cuda`` without a card, and its C
1-NN loop is ``tests/ref_impl.py``'s."""

import numpy as np
import pytest
import torch

from pctpu_torch.experiments import fuzz_campaign as fc
from pctpu_torch.experiments import oracle

from . import ref_impl

SMALL_RUN = ["--device=cpu", "--start=4000000", "--cases=1", "--prep-every=1", "--native=1",
             "--adversarial=1", "--misc=1", "--normals=1", "--icp=1", "--twostage=1",
             "--kitti-raw=2"]
REGIMES_ONLY = ["--device=cpu", "--start=4100000", "--cases=1"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_leg_runs_clean_on_the_cpu(capsys):
    assert fc.main(SMALL_RUN) == 0
    out = capsys.readouterr().out
    assert not [line for line in out.splitlines() if line.startswith("FAIL")]
    for leg in ("preprocess", "voxel", "topflatten", "native", "adversarial", "misc", "normals",
                "icp", "twostage", "kitti_raw"):
        assert f"leg {leg}: " in out and f"leg {leg}: 0 cases" not in out, leg
    assert "DONE: " in out


def _wrong_bev(real):
    def bev(cloud, height_res, *a, **k):
        multi, single = real(cloud, height_res, *a, **k)
        single = single.clone()
        single[100, 100] ^= 1
        return multi, single
    return bev


def _wrong_label(real):
    def mark(ordered, params, *a, **k):
        labeled, mat = real(ordered, params, *a, **k)
        label = labeled.label.clone()
        label[-1] = 7
        return labeled.replace(label=label), mat
    return mark


def _wrong_voxel(real):
    def vox(xyz, mask, leaf):
        out, valid, count = real(xyz, mask, leaf)
        return out + 1e-3, valid, count
    return vox


def _wrong_icp_step(real):
    def icp(*args):
        res, trace = real(*args)
        trace["transform"][1, 0, 3] += 0.01
        return res, trace
    return icp


def _wrong_rings(real):
    def rings(points):
        row, col, assigned = real(points)
        return row, (col + 1) % 2083, assigned
    return rings


@pytest.mark.parametrize("target,make,leg,argv", [
    ("fused_multi_single_bev", _wrong_bev, "preprocess", REGIMES_ONLY),
    ("mark_ground", _wrong_label, "preprocess", REGIMES_ONLY),
    ("voxel_downsample", _wrong_voxel, "voxel", REGIMES_ONLY),
    ("port_icp_trace", _wrong_icp_step, "icp", ["--device=cpu", "--cases=0", "--icp=1"]),
    ("kitti.assign_rings_raw", _wrong_rings, "kitti_raw",
     ["--device=cpu", "--cases=0", "--kitti-raw=2"]),
], ids=["one-bev-cell", "one-label", "voxel-centroids", "icp-step", "kitti-columns"])
def test_an_injected_fault_fails_its_leg(monkeypatch, capsys, target, make, leg, argv):
    owner = fc
    if "." in target:
        mod, target = target.split(".")
        owner = getattr(fc, mod)
    monkeypatch.setattr(owner, target, make(getattr(owner, target)))
    assert fc.main(argv) == 1
    out = capsys.readouterr().out
    assert f"FAIL {leg} seed=" in out


def test_card_against_cpu_check_fails_when_the_runs_differ(monkeypatch, capsys):
    """(b) on its own: the "card" run (here a second CPU run) given one
    wrong BEV cell, the oracle given the same wrong cell — only the
    comparison with the port's CPU run can see it."""
    real = fc.fused_multi_single_bev
    calls = []

    def bev(cloud, height_res, *a, **k):
        multi, single = real(cloud, height_res, *a, **k)
        calls.append(1)
        if len(calls) % 2 == 1:  # the first run of each case plays the card
            single = single.clone()
            single[100, 100] ^= 1
        return multi, single

    monkeypatch.setattr(fc, "fused_multi_single_bev", bev)
    camp = fc.Campaign("cpu")
    camp.cross = True
    pts = fc.fs.regime_points(np.random.default_rng(1), 50, 0.1, -2.5, 4.0, 2.0, 60.0, fc.SMALL)
    want = fc.python_oracle(camp.ref, pts, fc.SMALL)
    want["single"] = want["single"].copy()
    want["single"][100, 100] ^= 1
    fc.check_preprocess(camp, "preprocess", 1, fc.fs.point_arrays(pts), fc.SMALL, want)
    out = capsys.readouterr().out
    assert "FAIL preprocess seed=1 card vs CPU {'single': 1}" in out
    assert camp.failures == 1


@pytest.mark.parametrize("flips,far,verdict", [((3, 0), 0, "KNIFE"), ((3, 1), 1, "FAIL"),
                                                ((0, 0), 0, "FAIL")])
def test_d2_attribution_needs_its_evidence(monkeypatch, capsys, flips, far, verdict):
    """A difference from the oracle is D2 only with slope decisions that
    differ, all inside 1e-5° of the limit."""
    monkeypatch.setattr(fc, "mark_ground", _wrong_label(fc.mark_ground))
    monkeypatch.setattr(fc.oracle, "slope_disagreements", lambda *a, **k: flips)
    camp = fc.Campaign("cpu")
    pts = fc.fs.regime_points(np.random.default_rng(2), 50, 0.1, -2.5, 4.0, 2.0, 60.0, fc.SMALL)
    fc.check_preprocess(camp, "preprocess", 2, fc.fs.point_arrays(pts), fc.SMALL,
                        fc.python_oracle(camp.ref, pts, fc.SMALL))
    out = capsys.readouterr().out
    assert out.startswith(f"{verdict} preprocess seed=2 ")
    if verdict == "KNIFE":
        assert " D2 " in out and camp.failures == 0


def test_cuda_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fc.main(["--cases=1"]) == 2
    assert fc.main(["--device=cuda", "--cases=1"]) == 2
    assert "--device=cpu" in capsys.readouterr().err


def test_c_nn_is_the_python_loop():
    """``oracle.NnLoop`` returns ``ref_impl._nn_1_ref``'s index and d² —
    ties, masked targets, a NaN target, queries on a target, none allowed —
    including the last-bit cases where libm's ``powf`` square is not the
    product x·x."""
    rng = np.random.default_rng(5)
    nn = oracle.NnLoop()
    sq = np.float32(4097.0)
    assert float(sq ** 2) != float(sq * sq)  # numpy's f32 square is libm's powf
    for k in range(1500):
        n = int(rng.integers(1, 120))
        t = rng.uniform(-80, 80, (n, 3)).astype(np.float32)
        if k % 5 == 0:
            t[rng.integers(0, n, n // 2)] = t[0]
        if k % 9 == 0:
            t[rng.integers(0, n)] = np.nan
        q = t[rng.integers(0, n)].copy() if k % 7 == 0 else rng.uniform(-80, 80, 3).astype(
            np.float32)
        if k % 13 == 0:
            q[0] = np.float32(4097.0) + t[0, 0]
        ok = list(rng.random(n) > (1.5 if k % 17 == 0 else 0.3))
        assert nn(q, t, ok) == ref_impl._nn_1_ref(q, t, ok), k


@pytest.mark.parametrize("mode", ["point", "plane"])
def test_icp_oracle_with_the_c_loop_is_ref_impl_s(mode):
    """``icp_ref`` through ``oracle.ref_impl()`` gives ``tests/ref_impl.py``'s
    trace, transform and fitness bit for bit."""
    src, tgt, nrm, ok, cfg = fc.icp_case(3000007, mode)
    args = (src, tgt, np.eye(4, dtype=np.float32), cfg.max_correspondence_distance,
            cfg.max_iterations, cfg.transformation_epsilon, cfg.euclidean_fitness_epsilon)
    a = oracle.ref_impl().icp_ref(*args, tgt_normals=nrm, normal_ok=ok)
    b = ref_impl.icp_ref(*args, tgt_normals=nrm, normal_ok=ok)
    assert a["fitness"] == b["fitness"] and a["converged"] == b["converged"]
    np.testing.assert_array_equal(a["transform"], b["transform"])
    assert len(a["trace"]) == len(b["trace"])
    for (ta, ma, na), (tb, mb, nb) in zip(a["trace"], b["trace"]):
        np.testing.assert_array_equal(ta, tb)
        assert (ma == mb or (np.isnan(ma) and np.isnan(mb))) and na == nb


def test_campaign_seed_6000092_icp_near_tie(capsys):
    """Campaign find (seeds from 6,000,000, point mode, seed 6000092): at
    step 5 source point 46 has two targets within the NN score's d² window
    of each other; the port and pctpu both take the other one and part from
    the oracle by 0.0066 for one step, then rejoin it.  pctpu's contract
    fails there; the leg shows it as D3 with that evidence, and pctpu's own
    trace is the port's."""
    from pctpu.config import IcpConfig as JIcpConfig
    from pctpu.ops.icp import icp_trace as jicp_trace

    src, tgt, nrm, ok, cfg = fc.icp_case(6000092, "point")
    ref = fc.icp_oracle_stable(oracle.ref_impl(), src, tgt, nrm, ok, cfg)
    assert ref is not None  # the oracle's filter keeps the seed
    res, trace = fc.port_icp_trace(src, tgt, nrm, ok, cfg, torch.device("cpu"))
    win = 8.0 * float(np.max(np.sum(tgt * tgt, axis=1))) * 2.0**-23
    with pytest.raises(AssertionError, match="iteration 5 transform"):
        fc.icp_contract(res, trace, ref, "point", win)
    _, jtrace = jicp_trace(src, np.ones(len(src), bool), tgt, np.ones(len(tgt), bool),
                           np.eye(4, dtype=np.float32),
                           JIcpConfig(max_correspondence_distance=4.0, max_iterations=8))
    np.testing.assert_allclose(trace["transform"], np.asarray(jtrace["transform"]), atol=1e-5)

    camp = fc.Campaign("cpu")
    fc.run_icp(camp, 6000091, 1)
    out = capsys.readouterr().out
    assert camp.failures == 0
    assert ("KNIFE icp seed=6000092 mode=point D3 step 5, source point 46: targets 34 and 59"
            in out)
