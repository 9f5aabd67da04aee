"""The pair-batched registration path of pctpu_torch on the CPU: the cloud
helpers against pctpu's, K1's batched twin, the batched ICP, voxel grid,
top-part extraction and normals against their single forms (bit for bit),
the batched drivers against the port's sequential ones, the batched CLIs
against pctpu's ``pair_batch=2`` runs, and the pipelined stream.

The tree is ``test_torch_registration_e2e``'s scene (capacity 1024) with
three pairs, so ``pair_batch=2`` pads its tail.  Every coarse and fine
bucket of that tree is 1024 (the floor and the capacity), in a batch as
alone, so batched reports are byte-equal to sequential ones (D5: equal
capacity ⇒ bit-identical)."""

import dataclasses

import numpy as np
import pytest
import torch

import pctpu.cloud as jcloud
import pctpu.pipelines.registration as jreg
from pctpu_torch import cloud as tcloud
from pctpu_torch import make_cloud, registration_config_from
from pctpu_torch.cli import batch_top_part_registration as top_cli
from pctpu_torch.cli import batch_whole_registration as whole_cli
from pctpu_torch.config import IcpConfig, RegistrationConfig
from pctpu_torch.io import pcd as tpcd
from pctpu_torch.ops import cuda_knn, icp, normals2d, topflatten, voxel
from pctpu_torch.pipelines import registration as reg
from pctpu_torch.runtime import profiler

from .test_icp_differential import _plane_scene, scene
from .test_torch_ops_registration import _scene_cloud
from .test_torch_registration_e2e import SMALL, _base_scene, _pose

FIELDS = ("xyz", "intensity", "row", "col", "t", "label")
POSES = [(0.0, (0.0, 0.0)), (9.0, (0.5, -0.4)), (176.0, (1.0, 0.3))]
PAIRS = [(0, 1, 9.0), (0, 2, 174.0), (2, 1, -165.0)]
CFG = registration_config_from(dataclasses.asdict(SMALL))
WHOLE = RegistrationConfig(fine=IcpConfig(max_correspondence_distance=4.0, max_iterations=30))


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("batched")
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


def _clouds(tree):
    _, _, clouds = tree
    return [tpcd.load_cloud_pcd(f"{clouds}/{k:06d}.pcd", 1024, device="cpu")
            for k in range(len(POSES))]


# --- the cloud helpers (Queue 3 F5) ------------------------------------------

def test_cloud_helpers_match_pctpu():
    assert (tcloud.LABEL_UNSEGMENTED, tcloud.LABEL_GROUND) == (
        jcloud.LABEL_UNSEGMENTED, jcloud.LABEL_GROUND)
    got, want = (tcloud.to_numpy(tcloud.empty_cloud(37, device="cpu")),
                 jcloud.to_numpy(jcloud.empty_cloud(37)))
    assert got.keys() == want.keys() and got["count"] == want["count"] == 37
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    pairs = [_scene_cloud(seed) for seed in (3, 4)]
    ref = jcloud.stack_clouds([p[0] for p in pairs])
    stacked = tcloud.stack_clouds([p[1] for p in pairs])
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(stacked, k).numpy(),
                                      np.asarray(getattr(ref, k)).astype(
                                          getattr(stacked, k).numpy().dtype))
    np.testing.assert_array_equal(stacked.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(stacked.valid_mask().numpy(), np.asarray(ref.valid_mask()))
    back = tcloud.to_numpy(pairs[0][1])
    for k, v in jcloud.to_numpy(pairs[0][0]).items():
        np.testing.assert_array_equal(back[k], v)
        assert np.asarray(back[k]).dtype == np.asarray(v).dtype, k


# --- K1 over a problem axis (the CPU twin) -----------------------------------

@pytest.mark.parametrize("n_problems,n_targets,md", [(6, 3, 3.0), (4, 4, None), (1, 1, 2.0)])
def test_batched_pass_equals_single_passes(n_problems, n_targets, md):
    """Ragged valid counts, a target with no valid point, and two (or more)
    problems sharing one prepared target."""
    rng = np.random.default_rng(n_problems)
    nq, nt = 150, 230
    q = torch.from_numpy(rng.uniform(-20, 20, (n_problems, nq, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-20, 20, (n_targets, nt, 3)).astype(np.float32))
    qm = torch.from_numpy(rng.random((n_problems, nq)) > 0.1)
    tm = torch.from_numpy(rng.random((n_targets, nt)) > 0.1)
    qm[0, nq // 2:] = False
    tm[0, nt // 3:] = False
    if n_targets > 1:
        tm[-1] = False
    prep = cuda_knn.prepare_targets(t, tm)
    for b in range(n_targets):
        one = cuda_knn.prepare_target_reference(t[b], tm[b])
        for f in ("packed", "group_box", "tile_box"):
            _same(getattr(prep, f)[b], getattr(one, f))
    idx, d2 = cuda_knn.nn_1_pruned_batched(q, qm, prep, md)
    twin = cuda_knn.nn_1_pruned_batched_reference(q, qm, t, tm, md)
    per = n_problems // n_targets
    for p in range(n_problems):
        single = cuda_knn.nn_1_pruned(q[p], qm[p], prepared=cuda_knn.prepare_target(
            t[p // per], tm[p // per]), max_distance=md)
        for got, ref, want in zip((idx[p], d2[p]), (twin[0][p], twin[1][p]), single):
            _same(got, want)
            _same(ref, want)
    if n_targets > 1:
        assert torch.isinf(d2[-per:]).all() and not idx[-per:].any()
    assert torch.isinf(d2[~qm]).all()


def test_batched_pass_refuses_bad_problem_counts():
    q = torch.zeros((5, 4, 3))
    prep = cuda_knn.prepare_targets(torch.zeros((2, 8, 3)), torch.ones((2, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple"):
        cuda_knn.nn_1_pruned_batched(q, torch.ones((5, 4), dtype=torch.bool), prep)
    prep1 = cuda_knn.prepare_targets(torch.zeros((1, 8, 3)), torch.ones((1, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="65535"):
        cuda_knn.nn_1_pruned_batched(torch.zeros((65536, 1, 3)),
                                     torch.ones((65536, 1), dtype=torch.bool), prep1)


# --- the batched ICP ----------------------------------------------------------

def _icp_problems():
    """Four point-to-point problems over two targets: 0 runs to
    max_iterations, 1 aborts on < 3 correspondences, 2 converges at
    iteration 1 (source = target), 3 converges on the way."""
    src_a, tgt_a = scene(42)
    src_b, tgt_b = scene(43, yaw_deg=3.0, shift=(0.1, -0.1, 0.0))
    n = max(len(src_a), len(tgt_a))
    exact = tgt_b[: len(src_a)]
    srcs = [src_a, src_a, exact, src_b]
    pad = np.zeros((n, 3), np.float32)

    def padded(a):
        out = pad.copy()
        out[: len(a)] = a
        return out, np.arange(n) < len(a)

    s = [padded(a) for a in srcs]
    t = [padded(a) for a in (tgt_a, tgt_b)]
    far = np.eye(4, dtype=np.float32)
    far[0, 3] = 500.0
    guesses = np.stack([np.eye(4, dtype=np.float32), far, np.eye(4, dtype=np.float32),
                        np.eye(4, dtype=np.float32)])
    as_t = torch.from_numpy
    return (as_t(np.stack([a for a, _ in s])), as_t(np.stack([m for _, m in s])),
            as_t(np.stack([a for a, _ in t])), as_t(np.stack([m for _, m in t])),
            as_t(guesses))


@pytest.mark.parametrize("impl", ["xla", "pruned"])
def test_batched_icp_equals_single_calls(impl):
    src, sm, tgt, tm, guesses = _icp_problems()
    cfg = IcpConfig(max_correspondence_distance=1.0, max_iterations=5,
                    transformation_epsilon=1e-6, euclidean_fitness_epsilon=1e-4)
    with profiler.recording() as rec:
        got = icp.icp_batched(src, sm, tgt, tm, guesses, cfg, nn_impl=impl)
    # one host read a batch iteration: the batch ran to max_iterations once
    assert rec.total("icp.iterations") == cfg.max_iterations
    assert len(rec.named("icp.wait")) == cfg.max_iterations
    its = []
    for p in range(4):
        one = icp.icp(src[p], sm[p], tgt[p // 2], tm[p // 2], guesses[p], cfg, nn_impl=impl)
        _same(got.transform[p], one.transform)
        _same(got.fitness[p], one.fitness)
        assert bool(got.converged[p]) == bool(one.converged)
        _, trace = icp.icp_trace(src[p], sm[p], tgt[p // 2], tm[p // 2], guesses[p], cfg,
                                 nn_impl=impl)
        its.append(int(trace["it"][-1]))
    assert its[0] == cfg.max_iterations and its[1] == 1 and its[2] == 1
    assert its[3] < cfg.max_iterations
    assert not bool(got.converged[1]) and torch.equal(got.transform[1], guesses[1])
    assert bool(got.converged[0]) and bool(got.converged[2])


@pytest.mark.parametrize("impl", ["xla", "pruned"])
def test_batched_point_to_plane_shares_targets(impl):
    """The coarse stage's layout: two guesses a target, 2·B problems."""
    scenes = [_plane_scene(seed, 5.0, (0.2, -0.1, 0.0)) for seed in (200, 201)]
    n = max(max(len(s[0]), len(s[1])) for s in scenes)

    def pad(a, fill=0.0):
        out = np.full((n, *a.shape[1:]), fill, a.dtype)
        out[: len(a)] = a
        return out

    src = np.stack([pad(s[0]) for s in scenes for _ in range(2)])
    sm = np.stack([np.arange(n) < len(s[0]) for s in scenes for _ in range(2)])
    tgt = np.stack([pad(s[1]) for s in scenes])
    tm = np.stack([np.arange(n) < len(s[1]) for s in scenes])
    nrm = np.stack([pad(s[2]) for s in scenes])
    ok = np.stack([pad(s[3], False) for s in scenes])
    guesses = np.stack([reg._guess_pair_np(3.0)[g] for _ in scenes for g in range(2)])
    cfg = IcpConfig(max_correspondence_distance=10.0, max_iterations=6, point_to_plane=True)
    t = torch.from_numpy
    got = icp.icp_batched(t(src), t(sm), t(tgt), t(tm), t(guesses), cfg, t(nrm), t(ok),
                          nn_impl=impl)
    for p in range(4):
        one = icp.icp_point_to_plane(t(src[p]), t(sm[p]), t(tgt[p // 2]), t(tm[p // 2]),
                                     t(nrm[p // 2]), t(ok[p // 2]), t(guesses[p]), cfg,
                                     nn_impl=impl)
        _same(got.transform[p], one.transform)
        _same(got.fitness[p], one.fitness)


# --- the batched stage ops ---------------------------------------------------

def test_batched_stage_ops_equal_per_cloud():
    """Top-part extraction, the voxel grid (one sort of B·N rows, one
    segment-sum call) and both normal modes over a batch of three clouds,
    bit-equal to each cloud alone."""
    singles = [_scene_cloud(seed)[1] for seed in (3, 4, 5)]
    batch = tcloud.stack_clouds(singles)
    top = topflatten.extract_top_and_flatten(batch)
    vox = voxel.voxel_downsample(batch.xyz, batch.valid_mask(), 0.2)
    flat = voxel.voxel_downsample(top[0], top[1], 0.2)
    nrm = normals2d.normals_2d(flat[0], flat[1], radius=2.0)
    nrm_k = normals2d.normals_2d_knn(flat[0], flat[1], 6)
    for b, c in enumerate(singles):
        one_top = topflatten.extract_top_and_flatten(c)
        one_vox = voxel.voxel_downsample(c.xyz, c.valid_mask(), 0.2)
        one_flat = voxel.voxel_downsample(one_top[0], one_top[1], 0.2)
        for got, want in zip((*top, *vox, *flat), (*one_top, *one_vox, *one_flat)):
            _same(got[b], want)
        assert int(flat[2][b]) > 50
        for batched, fn in ((nrm, normals2d.normals_2d), (nrm_k, normals2d.normals_2d_knn)):
            arg = {"radius": 2.0} if fn is normals2d.normals_2d else {"k": 6}
            for got, want in zip(batched, fn(one_flat[0], one_flat[1], **arg)):
                _same(got[b], want)


# --- the batched drivers against the sequential ones -------------------------

def _top(tree, tmp_path, name, **kw):
    _, match, clouds = tree
    report = tmp_path / f"{name}.txt"
    out = reg.run_batch_top_part_registration(
        match, clouds, cfg=CFG, report_path=str(report), flat_cap=1024, device="cpu",
        **{"capacity": 1024, **kw})
    return out, report


def test_pair_batched_driver_matches_sequential(tree, tmp_path):
    seq, r1 = _top(tree, tmp_path, "seq", pair_batch=1)
    bat, r2 = _top(tree, tmp_path, "bat", pair_batch=2)  # 3 pairs → padded tail
    assert [r.success for r in seq] == [r.success for r in bat]
    assert sum(r.success for r in seq) >= 2
    for a, b in zip(seq, bat):
        np.testing.assert_allclose(a.transform_fine, b.transform_fine, atol=2e-3)
        # every bucket is 1024 in a batch as alone: bit-identical
        np.testing.assert_array_equal(a.transform_fine, b.transform_fine)
    assert r1.read_bytes() == r2.read_bytes()
    assert (tmp_path / "seq.txt.progress").read_bytes() == (tmp_path / "bat.txt.progress").read_bytes()


def test_whole_registration_batched_matches_sequential(tree, tmp_path):
    _, match, clouds = tree

    def run(name, pair_batch):
        return reg.run_batch_whole_registration(
            match, clouds, cfg=WHOLE, report_path=str(tmp_path / name), capacity=1024,
            pair_batch=pair_batch, device="cpu")

    seq, bat = run("w1.txt", 1), run("w2.txt", 2)  # padded tail
    assert seq == bat and sum(seq) == len(PAIRS)
    assert (tmp_path / "w2.txt").read_text() == ""
    assert (tmp_path / "w1.txt.progress").read_bytes() == (tmp_path / "w2.txt.progress").read_bytes()


def test_pair_batch_auto_capacity(tree, tmp_path, capsys):
    """pair_batch without a capacity derives one from the PCD headers."""
    root, _, clouds = tree
    match = root / "two.txt"
    match.write_text("0 1 9.0\n1 0 -9.0\n")
    reports = reg.run_batch_top_part_registration(
        str(match), clouds, cfg=CFG, flat_cap=1024, pair_batch=2, device="cpu",
        report_path=str(tmp_path / "r.txt"))
    assert len(reports) == 2 and all(r.success for r in reports)
    assert "capacity auto-derived from headers: 8192" in capsys.readouterr().out


def test_batch_driver_resume_with_pair_batch(tree, tmp_path):
    """--resume composes with pair batching: filtering happens before
    chunking, so a resumed run re-chunks only the remaining pairs (here a
    padded tail of one) and writes the lines the whole run wrote."""
    full, report = _top(tree, tmp_path, "report", pair_batch=2)
    progress = tmp_path / "report.txt.progress"
    assert progress.read_text().splitlines() == [f"{q} {m}" for q, m, _ in PAIRS]
    lines = report.read_text().splitlines()
    progress.write_text("".join(f"{q} {m}\n" for q, m, _ in PAIRS[:2]))
    report.write_text("".join(line + "\n" for line in lines[: sum(r.success for r in full[:2])]))
    rest, _ = _top(tree, tmp_path, "report", pair_batch=2, resume=True)
    assert [(r.query_idx, r.match_idx) for r in rest] == [PAIRS[2][:2]]
    assert report.read_text().splitlines() == lines
    assert progress.read_text().splitlines() == [f"{q} {m}" for q, m, _ in PAIRS]


def test_unported_driver_options_raise(tree, tmp_path, monkeypatch):
    """``devices``, ``num_processes`` and ``process_id`` are ported
    (tests/test_torch_parallel.py); a card mesh of more cards than the
    process sees still raises, and never runs on fewer."""
    _, match, clouds = tree
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, 1 CUDA cards visible"):
        reg.run_batch_whole_registration(match, clouds, report_path=str(tmp_path / "x"),
                                         devices=2, device="cuda", capacity=8192)


# --- the batched CLIs against pctpu's pair_batch=2 ---------------------------

def _parse(path):
    return [tuple(float(v) for v in line.split()) for line in open(path)]


def test_batched_clis_match_pctpu(tree, monkeypatch, capsys):
    root, match, clouds = tree
    ref_report = str(root / "pctpu_top.txt")
    ref = jreg.run_batch_top_part_registration(match, clouds, cfg=SMALL, report_path=ref_report,
                                               capacity=1024, flat_cap=1024, pair_batch=2)
    got = []

    def runner(*args, **kwargs):
        got.extend(reg.run_batch_top_part_registration(*args, cfg=CFG, **kwargs))
        return got

    monkeypatch.setattr(top_cli, "run_batch_top_part_registration", runner)
    port_report = str(root / "port_top.txt")
    assert top_cli.main([match, clouds, f"--report={port_report}", "--capacity=1024",
                         "--flat-cap=1024", "--device=cpu", "--pair-batch=2"]) == 0
    assert [r.success for r in got] == [r.success for r in ref]
    a, b = _parse(ref_report), _parse(port_report)
    assert len(a) == len(b) == sum(r.success for r in ref) >= 2
    for (xy_a, yaw_a), (xy_b, yaw_b) in zip(a, b):
        assert abs(xy_a - xy_b) <= 1e-4 and abs(yaw_a - yaw_b) <= 1e-3
    for r_ref, r_got in zip(ref, got):
        np.testing.assert_allclose(r_got.transform_fine, r_ref.transform_fine, atol=1e-4)

    # the whole-cloud CLI, each side's fine results recorded
    seen = {"pctpu": [], "port": []}
    for name, module in (("pctpu", jreg), ("port", reg)):
        real = module.register_whole_pairs

        def rec(*args, _real=real, _out=seen[name], **kwargs):
            res = _real(*args, **kwargs)
            _out.extend((float(np.asarray(r.fitness)), np.asarray(r.transform)) for r in res)
            return res

        monkeypatch.setattr(module, "register_whole_pairs", rec)
    counts = jreg.run_batch_whole_registration(match, clouds, report_path=str(root / "pw.txt"),
                                               capacity=1024, pair_batch=2)
    capsys.readouterr()
    assert whole_cli.main([match, clouds, f"--report={root / 'tw.txt'}", "--capacity=1024",
                           "--device=cpu", "--pair-batch=2"]) == 0
    assert f"count_success: {counts[0]}, count_failure: {counts[1]}," in capsys.readouterr().out
    assert (root / "tw.txt.progress").read_bytes() == (root / "pw.txt.progress").read_bytes()
    assert len(seen["port"]) == len(seen["pctpu"]) == 4  # two batches of two
    for (fit_r, tf_r), (fit_g, tf_g) in zip(seen["pctpu"], seen["port"]):
        assert abs(fit_g - fit_r) <= 1e-4 * fit_r
        np.testing.assert_allclose(tf_g, tf_r, atol=1e-4)


# --- the pipelined stream ---------------------------------------------------

def _batches(tree):
    c = _clouds(tree)
    return [[(c[0], c[1], 9.0), (c[1], c[0], -9.0)], [(c[0], c[2], 174.0)] * 2,
            [(c[2], c[1], -165.0), (c[0], c[1], 9.0)]]


def _assert_same_results(plain, piped):
    assert len(piped) == len(plain)
    for pb, qb in zip(plain, piped):
        for (b1, f1), (b2, f2) in zip(pb, qb):
            np.testing.assert_array_equal(b1.transform, b2.transform)
            np.testing.assert_array_equal(f1.transform, f2.transform)
            assert float(f1.fitness) == float(f2.fitness)


def test_register_pairs_pipelined_matches_plain(tree):
    batches = _batches(tree)
    plain = [reg.register_pairs(b, CFG, flat_cap=1024) for b in batches]
    for depth in (1, 2):
        _assert_same_results(plain, list(reg.register_pairs_pipelined(
            iter([lambda b=b: b for b in batches]), CFG, flat_cap=1024, depth=depth)))
    with pytest.raises(ValueError, match="depth"):
        list(reg.register_pairs_pipelined(iter([]), CFG, depth=0))


def _forced_spec(monkeypatch, coarse, fine):
    """A BucketSpec that starts with the given predictions (so the first
    batch already runs speculatively), kept for inspection."""
    captured = {}

    class Forced(reg.BucketSpec):
        def __init__(self):
            super().__init__()
            self.coarse, self.fine = coarse, fine
            captured["spec"] = self

    monkeypatch.setattr(reg, "BucketSpec", Forced)
    return captured


def test_pipelined_speculation_mispredict_matches_plain(tree, monkeypatch):
    """Both stages mispredicted on the first batch (512 against 1024): the
    speculative results are dropped and the stages run again; the second
    batch then hits both."""
    batches = _batches(tree)[:2]
    plain = [reg.register_pairs(b, CFG, flat_cap=1024) for b in batches]
    captured = _forced_spec(monkeypatch, 512, 512)
    _assert_same_results(plain, list(reg.register_pairs_pipelined(
        iter([lambda b=b: b for b in batches]), CFG, flat_cap=1024)))
    spec = captured["spec"]
    assert (spec.misses, spec.hits, spec.coarse, spec.fine) == (2, 2, 1024, 1024)


def test_coarse_mispredict_invalidates_speculative_fine(tree, monkeypatch):
    """The coarse bucket mispredicted, the fine one right: the speculative
    fine started from the mispredicted coarse winners, so it runs again."""
    batches = _batches(tree)[:1]
    plain = [reg.register_pairs(b, CFG, flat_cap=1024) for b in batches]
    captured = _forced_spec(monkeypatch, 512, 1024)
    fines = []
    real = reg._stage_fine
    monkeypatch.setattr(reg, "_stage_fine", lambda *a: fines.append(a[-1]) or real(*a))
    _assert_same_results(plain, list(reg.register_pairs_pipelined(
        iter([lambda b=b: b for b in batches]), CFG, flat_cap=1024)))
    spec = captured["spec"]
    assert (spec.misses, spec.hits) == (1, 1)
    assert fines == [1024, 1024]  # the speculative fine and its re-run


def test_pipelined_driver_propagates_loader_errors(tree, tmp_path):
    """A missing PCD in a later chunk raises out of the worker thread."""
    root, _, clouds = tree
    match = root / "missing.txt"
    match.write_text("0 1 9.0\n0 1 9.0\n0 7 5.0\n")
    with pytest.raises((FileNotFoundError, OSError)):
        reg.run_batch_top_part_registration(str(match), clouds, cfg=CFG, flat_cap=1024,
                                            capacity=1024, pair_batch=2, device="cpu",
                                            report_path=str(tmp_path / "r.txt"))


def test_default_pair_batch_follows_the_device(tree, tmp_path, capsys):
    assert reg.default_pair_batch("cuda") == reg.default_pair_batch(torch.device("cuda", 0)) == 16
    assert reg.default_pair_batch("cpu") == 1
    root, _, clouds = tree
    empty = root / "empty.txt"
    empty.write_text("")
    reg.run_batch_top_part_registration(str(empty), clouds, report_path=str(tmp_path / "e.txt"),
                                        device="cpu")
    assert "pair_batch auto-selected for cpu: 1" in capsys.readouterr().out
    assert reg.default_pair_batch() == 16  # the entry points' own default device
