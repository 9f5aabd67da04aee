"""pctpu_torch's bbox-pruned 1-NN against pctpu's Pallas kernels.

The port's plain twin ``nn_1_pruned_reference`` (what ``nn_1_pruned`` runs
for CPU tensors) is held against ``pctpu.ops.pallas_knn.pallas_nn_1_pruned``
in interpret mode, with both the 1-D-grid loop kernel and the 2-D-grid
kernel.  pctpu picks winners on |t|² − 2q·t scores and the port on the direct
(q−t)², so indices are compared on queries whose best and second-best
distances differ by more than the score window 4·|p|²·2⁻²³; where the
indices agree the distances must be bit-equal.  The CUDA kernel itself runs
only on a card: ``chip_smoke.py`` holds it against the twin there."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops import pallas_knn as pk
from pctpu_torch.ops import cuda_knn as tk

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _sorted_clouds(seed, nq, nt, masked):
    """Morton-sorted random query and target clouds (sorted by pctpu), with
    about 10% of each masked when ``masked``."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-50, 50, (nq, 3)).astype(np.float32)
    t = rng.uniform(-50, 50, (nt, 3)).astype(np.float32)
    qm = rng.random(nq) > (0.1 if masked else -1.0)
    tm = rng.random(nt) > (0.1 if masked else -1.0)
    qs, qsm, _ = pk.spatial_sort(jnp.asarray(q), jnp.asarray(qm))
    ts, tsm, _ = pk.spatial_sort(jnp.asarray(t), jnp.asarray(tm))
    return tuple(np.asarray(a) for a in (qs, qsm, ts, tsm))


def _unambiguous(q, t, tm):
    """Queries whose exact best and second-best d² differ by more than the
    score window 4·|p|²·2⁻²³ (pallas_knn.py:355-365)."""
    d = ((q[:, None, :].astype(np.float64) - t[None].astype(np.float64)) ** 2).sum(-1)
    d[:, ~tm] = np.inf
    part = np.partition(d, 1, axis=1)
    p2 = max(float((q.astype(np.float64) ** 2).sum(1).max()),
             float((t.astype(np.float64) ** 2).sum(1).max()))
    return (part[:, 1] - part[:, 0]) > 4.0 * p2 * 2.0**-23


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kernel", ["loop", "2d"])
@pytest.mark.parametrize("md", [None, 2.0, 8.0])
def test_twin_matches_pallas_kernel(kernel, md):
    q, qm, t, tm = _sorted_clouds(7, 400, 1300, masked=True)
    i_p, d_p = pk.pallas_nn_1_pruned(q, qm, t, tm, max_distance=md, tq=128,
                                     tt=256, interpret=True, kernel=kernel)
    i_p, d_p = np.asarray(i_p), np.asarray(d_p)
    i_t, d_t = tk.nn_1_pruned(_t(q), _t(qm), _t(t), _t(tm), max_distance=md)
    i_t, d_t = i_t.numpy(), d_t.numpy()

    thr2 = np.inf if md is None else np.float32(md) ** 2
    found = np.isfinite(d_t)
    assert np.all(~found | (d_t <= thr2))
    assert np.all(~np.isfinite(d_t[~qm]))
    sure = qm & _unambiguous(q, t, tm)
    assert sure.sum() > 0.9 * qm.sum()
    # within the threshold: the same winner, bit-equal distance
    np.testing.assert_array_equal(i_t[sure & found], i_p[sure & found])
    agree = qm & found & (i_t == i_p)
    np.testing.assert_array_equal(d_t[agree], d_p[agree])
    # beyond it: the port gives +inf, pctpu +inf or a finite d² > thr²
    beyond = qm & ~found
    assert np.all(~np.isfinite(d_p[beyond]) | (d_p[beyond] > thr2))
    if md is not None:
        assert beyond.any() and found.any()


def test_twin_is_exact_first_minimum():
    """The twin is the exact 1-NN on fma(dz, dz, fma(dy, dy, dx·dx)) with
    ties to the lowest index, which is the kernel's contract on the card."""
    q, qm, t, tm = _sorted_clouds(3, 300, 900, masked=True)
    i_t, d_t = tk.nn_1_pruned_reference(_t(q), _t(qm), _t(t), _t(tm), block=4096)
    diff = (q[:, None, :] - t[None]).astype(np.float64)

    def fma(a, b, c):  # f64 product is exact; the sum rounds once more
        return (a * b + c.astype(np.float64)).astype(np.float32)

    dx2 = (diff[..., 0] * diff[..., 0]).astype(np.float32)
    d = fma(diff[..., 2], diff[..., 2], fma(diff[..., 1], diff[..., 1], dx2))
    d[:, ~tm] = np.inf
    np.testing.assert_array_equal(i_t.numpy()[qm], d.argmin(1)[qm])
    np.testing.assert_array_equal(d_t.numpy()[qm], d.min(1)[qm])


def test_ties_go_to_lowest_index():
    """Duplicate targets in different tiles: the lowest index wins."""
    t = np.full((2048, 3), 50.0, np.float32)
    t[5] = t[1500] = [1.0, 2.0, 3.0]
    t[1200] = [-1.0, -2.0, -3.0]  # the same distance from the origin query
    q = np.zeros((4, 3), np.float32)
    q[1] = [1.0, 2.0, 3.5]
    ones = np.ones(2048, bool)
    idx, d2 = tk.nn_1_pruned(_t(q), _t(np.ones(4, bool)), _t(t), _t(ones))
    assert idx.tolist() == [5, 5, 5, 5]
    assert d2[0].item() == 14.0 and d2[1].item() == 0.25
    # with the first duplicate masked, the next one by index wins
    ones[5] = False
    idx, _ = tk.nn_1_pruned(_t(q), _t(np.ones(4, bool)), _t(t), _t(ones))
    assert idx.tolist() == [1200, 1500, 1200, 1200]


def _without_nan_targets(q, qm, t, tm, md, **kw):
    """pctpu's answer with the targets that hold a NaN coordinate deleted
    (valid or masked), its indices mapped back to the full target."""
    keep = np.flatnonzero(~np.isnan(t).any(axis=1))
    i_p, d_p = pk.pallas_nn_1_pruned(q, qm, t[keep], tm[keep], max_distance=md,
                                     interpret=True, **kw)
    i_p, d_p = np.asarray(i_p), np.asarray(d_p)
    return np.where(np.isfinite(d_p), keep[i_p], 0), d_p


@pytest.mark.parametrize("valid", [True, False])
def test_nan_target_line_scene(valid):
    """ROADMAP F13: 3,000 targets 0.1 m apart on the x axis, target 2,500 at
    (NaN, 0, 0), valid or masked; a query every 300th target, 5 cm off in y.
    pctpu (interpret mode, 1,024-target tiles) loses the whole tile that
    holds the NaN, masked or not, and answers 2,047 for the queries at
    2,100, 2,400 and 2,700.  The port's rule (README D23): a NaN target is
    never found and costs no other target anything — pctpu's answer with
    the NaN target deleted; the prepared-target path agrees."""
    t = np.zeros((3000, 3), np.float32)
    t[:, 0] = np.arange(3000, dtype=np.float32) * np.float32(0.1)
    t[2500] = [np.nan, 0.0, 0.0]
    tm = np.ones(3000, bool)
    tm[2500] = valid
    q = t[::300].copy()
    q[8, 0] = t[2400, 0]  # target 2,400 itself lies in the tile of the NaN
    q[:, 1] = np.float32(0.05)
    qm = np.ones(len(q), bool)
    want = np.arange(0, 3000, 300)
    want[8] = 2400
    i_p, _ = pk.pallas_nn_1_pruned(q, qm, t, tm, interpret=True)
    i_p = np.asarray(i_p)
    lost = np.isin(want, (2100, 2400, 2700))
    np.testing.assert_array_equal(i_p[lost], 2047)  # pctpu's own fault, pinned
    np.testing.assert_array_equal(i_p[~lost], want[~lost])
    i_del, d_del = _without_nan_targets(q, qm, t, tm, None)
    np.testing.assert_array_equal(i_del, want)
    for prepared in (False, True):
        if prepared:
            prep = tk.prepare_target(_t(t), _t(tm))
            i_t, d_t = tk.nn_1_pruned(_t(q), _t(qm), prepared=prep)
        else:
            i_t, d_t = tk.nn_1_pruned(_t(q), _t(qm), _t(t), _t(tm))
        np.testing.assert_array_equal(i_t.numpy(), want)
        np.testing.assert_array_equal(d_t.numpy(), d_del)


@pytest.mark.parametrize("seed,md", [(21, None), (22, 2.0), (23, 8.0)])
def test_nan_targets_equal_pctpu_without_them(seed, md):
    """A seeded scene with NaN coordinates in valid and in masked targets
    (queries all finite: a NaN query costs pctpu its whole query tile): the
    port's CPU ``nn_1_pruned`` (and the batched
    twin) equals pctpu's answer on the same inputs with the NaN targets
    deleted, up to pctpu's score window (as in
    :func:`test_twin_matches_pallas_kernel`)."""
    q, qm, t, tm = (a.copy() for a in _sorted_clouds(seed, 300, 2500, masked=True))
    rng = np.random.default_rng(seed)
    bad = rng.choice(2500, 12, replace=False)
    t[bad, rng.integers(0, 3, 12)] = np.nan
    tm[bad[:6]] = True
    i_p, d_p = _without_nan_targets(q, qm, t, tm, md, tq=128, tt=256)
    i_t, d_t = (a.numpy() for a in tk.nn_1_pruned(_t(q), _t(qm), _t(t), _t(tm),
                                                    max_distance=md))
    assert not np.isin(i_t, bad).any()
    keep = ~np.isnan(t).any(axis=1)
    sure = qm & _unambiguous(q, t[keep], tm[keep])
    found = np.isfinite(d_t)
    thr2 = np.inf if md is None else np.float32(md) ** 2
    np.testing.assert_array_equal(found, np.isfinite(d_p) & (d_p <= thr2))
    assert sure.sum() > 0.8 * qm.sum() and found.any()
    np.testing.assert_array_equal(i_t[sure & found], i_p[sure & found])
    agree = qm & found & (i_t == i_p)
    np.testing.assert_array_equal(d_t[agree], d_p[agree])
    prep = tk.prepare_targets(_t(t)[None], _t(tm)[None])
    i_b, d_b = tk.nn_1_pruned_batched(_t(q)[None], _t(qm)[None], prep, max_distance=md)
    np.testing.assert_array_equal(i_b[0].numpy(), i_t)
    np.testing.assert_array_equal(d_b[0].numpy(), d_t)


def test_sort_helpers_bit_equal():
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-80, 80, (1024, 3)).astype(np.float32)
    xyz[:7] = -0.0
    mask = rng.random(1024) > 0.2
    mask[256:512] = False  # a fully masked tile
    key_p = np.asarray(pk.morton_sort_key(jnp.asarray(xyz), jnp.asarray(mask)))
    key_t = tk.morton_sort_key(_t(xyz), _t(mask)).numpy()
    assert key_t.dtype == np.int32
    np.testing.assert_array_equal(key_t, key_p)
    for tile in (128, 256):
        box_p = np.asarray(pk._tile_bboxes(jnp.asarray(xyz), jnp.asarray(mask), tile))
        box_t = tk._tile_bboxes(_t(xyz), _t(mask), tile).numpy()
        np.testing.assert_array_equal(box_t.view(np.uint32), box_p.view(np.uint32))


@pytest.mark.parametrize("seed,n", [(3, 1), (4, 997), (5, 4096)])
def test_spatial_sort_matches_pctpu(seed, n):
    """pctpu's ``spatial_sort`` (a stable ``jnp.argsort`` of the Morton key)
    and the port's: the same order, bit-equal points and masks, ties of
    equal keys (a coarse lattice) and masked points included."""
    rng = np.random.default_rng(seed)
    xyz = rng.integers(-20, 20, (n, 3)).astype(np.float32) * 0.5
    xyz[: n // 3] = rng.uniform(-30, 30, (n // 3, 3)).astype(np.float32)
    mask = rng.random(n) > 0.2
    want = pk.spatial_sort(jnp.asarray(xyz), jnp.asarray(mask))
    got = tk.spatial_sort(_t(xyz), _t(mask))
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), xyz[got[2].numpy()])


def test_spatial_sort_payload_matches_per_key_run():
    """pctpu's lax.sort is not stable, the port's sort is: the sorted keys
    agree exactly and each run of equal keys holds the same rows."""
    rng = np.random.default_rng(12)
    n = 2000
    # a coarse lattice so that many points share a Morton key
    xyz = rng.integers(-20, 20, (n, 3)).astype(np.float32) * 0.5
    mask = rng.random(n) > 0.1
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nok = rng.random(n) > 0.3
    out_p = pk.spatial_sort_payload(jnp.asarray(xyz), jnp.asarray(mask),
                                    jnp.asarray(nrm), jnp.asarray(nok.astype(np.int32)))
    out_t = tk.spatial_sort_payload(_t(xyz), _t(mask), _t(nrm), _t(nok))
    key_p = np.asarray(pk.morton_sort_key(out_p[0], out_p[1]))
    key_t = tk.morton_sort_key(out_t[0], out_t[1]).numpy()
    np.testing.assert_array_equal(key_t, key_p)

    def rows(out, i):
        cols = [np.asarray(a).reshape(n, -1).astype(np.float64) for a in out]
        return np.concatenate(cols, axis=1)[i]

    rows_p = rows(out_p, slice(None))
    rows_t = rows([o.numpy() for o in out_t], slice(None))
    starts = np.flatnonzero(np.r_[True, key_t[1:] != key_t[:-1], True])
    assert len(starts) - 1 < n  # runs of equal keys exist
    for a, b in zip(starts[:-1], starts[1:]):
        rp = rows_p[a:b][np.lexsort(rows_p[a:b].T)]
        rt = rows_t[a:b][np.lexsort(rows_t[a:b].T)]
        np.testing.assert_array_equal(rt, rp)
    # the port's sort is stable: each run is in input order
    order = torch.sort(tk.morton_sort_key(_t(xyz), _t(mask)), stable=True).indices
    np.testing.assert_array_equal(out_t[0].numpy(), xyz[order.numpy()])


@pytest.mark.parametrize("n", [1, 45, 1024, 2500])
def test_prepare_target_boxes(n):
    """The prep twin: packed points in the target's order with +inf for
    masked and padding rows; every group and tile box holds its valid
    points, and an all-masked group gets pctpu's impossible box."""
    rng = np.random.default_rng(n)
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    mask = rng.random(n) > 0.2
    mask[32:64] = False  # an all-masked group when n > 32
    prep = tk.prepare_target(_t(xyz), _t(mask))
    tiles = -(-n // 1024)
    packed, gbox, tbox = prep.packed.numpy(), prep.group_box.numpy(), prep.tile_box.numpy()
    assert prep.n == n and packed.shape == (tiles * 1024, 4)
    assert gbox.shape == (8, tiles * 32) and tbox.shape == (8, tiles)
    np.testing.assert_array_equal(packed[:n][mask, :3], xyz[mask])
    assert np.all(np.isinf(packed[:n][~mask, :3])) and np.all(np.isinf(packed[n:, :3]))
    assert not packed[:, 3].any() and not gbox[6:].any() and not tbox[6:].any()
    pad = np.zeros(tiles * 1024, bool)
    pad[:n] = mask
    pts = np.zeros((tiles * 1024, 3), np.float32)
    pts[:n] = xyz
    for box, size in ((gbox, 32), (tbox, 1024)):
        for c in range(box.shape[1]):
            sel = pad[c * size:(c + 1) * size]
            run = pts[c * size:(c + 1) * size][sel]
            if sel.any():
                assert np.all(box[0:3, c] <= run.min(0)) and np.all(box[3:6, c] >= run.max(0))
            else:
                assert np.all(box[0:3, c] == np.float32(3e38))
                assert np.all(box[3:6, c] == np.float32(-3e38))
    if n > 64:
        assert np.all(gbox[0:3, 1] == np.float32(3e38))


def test_prepared_tile_boxes_equal_pctpu():
    """At 1,024 points the prep twin's tile boxes are pctpu's
    ``_tile_bboxes`` (by value: the prep stores −0 as +0)."""
    rng = np.random.default_rng(13)
    xyz = rng.uniform(-80, 80, (3000, 3)).astype(np.float32)
    xyz[:7] = -0.0
    mask = rng.random(3000) > 0.2
    mask[1024:2048] = False  # a fully masked tile
    prep = tk.prepare_target(_t(xyz), _t(mask))
    pad = np.zeros((3072, 3), np.float32)
    pad[:3000] = xyz
    pmask = np.zeros(3072, bool)
    pmask[:3000] = mask
    want = np.asarray(pk._tile_bboxes(jnp.asarray(pad), jnp.asarray(pmask), 1024))
    got = prep.tile_box.numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.signbit(got[got == 0]).any()


@pytest.mark.parametrize("md", [None, 2.0])
def test_prepared_matches_pallas_kernel(md):
    """``nn_1_pruned`` on a prepared target equals the path without one and
    matches pctpu's loop kernel in interpret mode, as
    :func:`test_twin_matches_pallas_kernel` holds it."""
    q, qm, t, tm = _sorted_clouds(8, 300, 1500, masked=True)
    args = tuple(map(_t, (q, qm, t, tm)))
    prep = tk.prepare_target(args[2], args[3])
    i_t, d_t = tk.nn_1_pruned(*args[:2], max_distance=md, prepared=prep)
    i_u, d_u = tk.nn_1_pruned(*args, max_distance=md)
    assert torch.equal(i_t, i_u) and torch.equal(d_t.view(torch.int32), d_u.view(torch.int32))
    i_p, d_p = pk.pallas_nn_1_pruned(q, qm, t, tm, max_distance=md, tq=128, tt=256,
                                     interpret=True, kernel="loop")
    i_p, d_p, i_t, d_t = np.asarray(i_p), np.asarray(d_p), i_t.numpy(), d_t.numpy()
    found = np.isfinite(d_t)
    sure = qm & _unambiguous(q, t, tm)
    assert sure.sum() > 0.9 * qm.sum()
    np.testing.assert_array_equal(i_t[sure & found], i_p[sure & found])
    agree = qm & found & (i_t == i_p)
    np.testing.assert_array_equal(d_t[agree], d_p[agree])
    # the mask lives in the prepared target alone: a pass given both, or
    # neither, raises, so no pass can run with a mask it was not prepared with
    for target in ((args[2], ~args[3]), (args[2], args[3]), (None, args[3])):
        with pytest.raises(ValueError):
            tk.nn_1_pruned(*args[:2], *target, max_distance=md, prepared=prep)
    with pytest.raises(ValueError):
        tk.nn_1_pruned(*args[:2], max_distance=md)


def test_prepared_pass_uses_the_prepared_mask():
    """A pass on a prepared target searches the mask it was prepared with:
    a second mask prepared from the same points gives that mask's answer."""
    q, qm, t, tm = _sorted_clouds(9, 200, 900, masked=True)
    args = tuple(map(_t, (q, qm, t, tm)))
    other = args[3] & _t(np.random.default_rng(9).random(900) > 0.5)
    for mask in (args[3], other):
        got = tk.nn_1_pruned(*args[:2], prepared=tk.prepare_target(args[2], mask),
                             max_distance=4.0)
        want = tk.nn_1_pruned_reference(*args[:3], mask, max_distance=4.0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], tk.nn_1_pruned(*args, max_distance=4.0)[0])


@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_prepares_each_target_once(monkeypatch, point_to_plane):
    """``icp`` prepares the correspondence target and the fitness target
    once per call (one object when the masks are the same), and its
    transforms equal those of passes that prepare nothing."""
    from pctpu_torch.config import IcpConfig
    from pctpu_torch.ops import icp as icp_mod

    rng = np.random.default_rng(21)
    tgt = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    th = np.radians(4.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                   np.float32)
    src = (tgt @ rot.T + np.float32([0.3, -0.2, 0.0])).astype(np.float32)
    tm = rng.random(700) > 0.1
    nrm = rng.normal(size=(700, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nok = rng.random(700) > 0.2
    cfg = IcpConfig(max_correspondence_distance=2.0, max_iterations=6,
                    point_to_plane=point_to_plane)
    extra = dict(tgt_normals=_t(nrm), normal_mask=_t(nok)) if point_to_plane else {}
    made = {}  # id of each prepared target -> the (target, mask) it was made from
    real_prepare = icp_mod.prepare_target

    def recording(*a):
        prep = real_prepare(*a)
        made[id(prep)] = a
        return prep

    def run():
        return icp_mod.icp(_t(src), torch.ones(700, dtype=torch.bool), _t(tgt), _t(tm),
                           torch.eye(4), cfg, nn_impl="pruned", **extra)

    monkeypatch.setattr(icp_mod, "prepare_target", recording)
    prepared = run()
    assert len(made) == (2 if point_to_plane else 1)
    real_nn = icp_mod.nn_1_pruned
    # the same passes on the unprepared path, given what each target was made from
    monkeypatch.setattr(icp_mod, "nn_1_pruned", lambda q, qm, prepared, max_distance:
                        real_nn(q, qm, *made[id(prepared)], max_distance=max_distance))
    bare = run()
    assert torch.equal(prepared.transform, bare.transform)
    assert torch.equal(prepared.fitness, bare.fitness)
    assert bool(prepared.converged) and torch.isfinite(prepared.fitness)


_CLIS = {
    "batch_top_part_registration": ["match.txt", "clouds"],
    "batch_whole_registration": ["match.txt", "clouds"],
    "batch_multi_bev_gen": ["root", "HDL_64E"],
    "batch_cloud_manip": ["root"],
    "cloud_manip": ["scan.pcd", "1", "2", "0", "30"],
}


@pytest.mark.parametrize("name", sorted(_CLIS))
def test_cli_needs_card_or_device_cpu(name, capsys):
    """With no CUDA card and no ``--device=cpu`` a CLI stops with a message
    naming the flag; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would run on it")
    cli = __import__(f"pctpu_torch.cli.{name}", fromlist=["main"])
    with pytest.raises(SystemExit) as exc:
        cli.main(_CLIS[name])
    assert exc.value.code != 0
    assert "--device=cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        cli.main([*_CLIS[name], "--device=tpu"])
    assert exc.value.code != 0


@pytest.mark.parametrize("entry", ["registration.run_batch_top_part_registration",
                                   "registration.run_batch_whole_registration",
                                   "multi_bev.run_multi_bev",
                                   "batch_cloud_manip.run_batch_cloud_manip",
                                   "cloud_manip.run_cloud_manip"])
def test_entry_points_default_to_cuda(entry):
    import inspect

    module, fn = entry.split(".")
    mod = __import__(f"pctpu_torch.pipelines.{module}", fromlist=[fn])
    assert inspect.signature(getattr(mod, fn)).parameters["device"].default == "cuda"


class _RecordingLibrary:
    """Stand-in for the kernel library: records each entry's arguments and
    reports success, launching nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("pctpu_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _pass_inputs(n_problems, nq, nt, batched):
    rng = np.random.default_rng(nq + nt)
    q = torch.from_numpy(rng.uniform(-5, 5, (n_problems, nq, 3)).astype(np.float32))
    qm = torch.ones((n_problems, nq), dtype=torch.bool)
    t = torch.from_numpy(rng.uniform(-5, 5, (1, nt, 3)).astype(np.float32))
    tm = torch.ones((1, nt), dtype=torch.bool)
    if batched:
        return q, qm, tk.prepare_targets_reference(t, tm)
    return q[0], qm[0], tk.prepare_target_reference(t[0], tm[0])


def _stand_in(monkeypatch):
    """The kernel library replaced by a recorder, and the card checks let
    through, so that ``_pass_launcher`` runs its host side on the CPU."""
    from pctpu_torch.ops import _cuda

    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_cuda, "require_card", lambda dev, what: None)
    monkeypatch.setattr(_cuda, "launch_counts", dict.fromkeys(_cuda.launch_counts, 0))
    return lib, _cuda.launch_counts


@pytest.mark.parametrize("n_problems,nq,nt", [
    (1, 1, 1), (1, 1000, 3 * 1024 + 7), (16, 4096, 5000), (32, 8192, 8192),
    (2, 32 * 37 + 1, 3000),   # one query past a whole warp
    (4, 2000, 4 * 1024),      # targets an exact multiple of the tile
    (1, 32, 1000),            # one query warp, one tile
    (128, 8192, 8192),        # the coarse stage at --pair-batch=64: two guesses a pair
])
def test_pass_scratch_holds_the_work_list(monkeypatch, n_problems, nq, nt):
    """``_pass_launcher`` sizes the pass's scratch from (P, Q, tiles): the
    list's count and a spare word, each problem's warp boxes (4 words a
    query warp) and keys (a word a query), and room for every (problem,
    query warp, tile) item."""
    _stand_in(monkeypatch)
    warps, tiles = -(-nq // 32), -(-nt // 1024)
    want = 2 + n_problems * (4 * warps + nq + warps * tiles)
    assert tk._pass_scratch_words(n_problems, nq, tiles) == want
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        out = empty(*shape, **kw)
        made.append((tuple(out.shape), out.dtype))
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    tk._pass_launcher(*_pass_inputs(n_problems, nq, nt, batched=n_problems > 1),
                      tk._thr2(1.0))
    assert made.count(((want,), torch.int64)) == 1, made


@pytest.mark.parametrize("batched", [False, True])
def test_pass_launcher_entries_and_counts(monkeypatch, batched):
    """The pass and its counting instance call the C entry of their kind of
    target, each counted under its own name once a launch; the counting
    instance gets the counter, the pass none."""
    lib, counts = _stand_in(monkeypatch)
    q, qm, prep = _pass_inputs(3 if batched else 1, 100, 2100, batched)
    new_entry = "pctpu_nn_pruned_batched" if batched else "pctpu_nn_pruned"
    counter = torch.zeros((2,), dtype=torch.int64)
    for kw, entry, name in (
            ({}, new_entry, "nn_pruned_batched" if batched else "nn_pruned"),
            ({"counter": counter}, new_entry, "nn_pruned_count")):
        before = dict(counts)
        launch, idx, d2 = tk._pass_launcher(q, qm, prep, tk._thr2(2.0), **kw)
        assert not lib.calls and counts == before  # nothing launches before launch()
        launch()
        launch()
        assert [c[0] for c in lib.calls] == [entry, entry]
        args = lib.calls[0][1]
        assert args[0] == q.data_ptr() and args[-1] == 0  # queries first, the stream last
        assert idx.data_ptr() in args and d2.data_ptr() in args
        assert args[args.index(d2.data_ptr()) + 1:-1] == (
            counter.data_ptr() if kw.get("counter") is not None else None,)
        assert {k: counts[k] - before[k] for k in counts if counts[k] != before[k]} == {name: 2}
        lib.calls.clear()


@pytest.mark.parametrize("batched", [False, True])
def test_pass_launcher_needs_cuda(batched):
    """The kernels' pass has no CPU mode: ``_pass_launcher`` on CPU tensors
    raises before it allocates or launches anything, and nothing is
    counted."""
    from pctpu_torch.ops import _cuda

    before = dict(_cuda.launch_counts)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        tk._pass_launcher(*_pass_inputs(2 if batched else 1, 64, 1500, batched), tk._thr2(1.0))
    assert _cuda.launch_counts == before


@pytest.mark.parametrize("nn_impl", ["pruned", "xla"])
def test_icp_pruned_nan_normal_not_poisoning(nn_impl):
    """(tests/test_pallas_knn.py:133) A NaN normal on an excluded target
    (normal_mask False) and masked source padding do not NaN-poison the
    point-to-plane solve, through the pruned path's twin (the idx-0
    convention for unmatched queries) or the brute force: both finite,
    within 1e-5 of pctpu's ``nn_impl="xla"`` on the same inputs."""
    from pctpu.config import IcpConfig as JIcpConfig
    from pctpu.ops.icp import icp_point_to_plane as jicp

    from .test_torch_cuda_kernels import NAN_NORMAL_ICP, icp_nan_normal, nan_normal_scene

    want = jicp(*nan_normal_scene(), JIcpConfig(**NAN_NORMAL_ICP), nn_impl="xla")
    got = icp_nan_normal("cpu", nn_impl)
    assert np.isfinite(got.transform).all() and np.isfinite(got.fitness)
    np.testing.assert_allclose(got.transform, np.asarray(want.transform), atol=1e-5)


def test_port_imports_no_jax():
    """Importing the port pulls in neither jax nor pctpu, and builds
    nothing: the CUDA library is compiled at first launch only.  The tools
    ported from pctpu's scripts and the port's examples import with
    ``jax``, ``pctpu``, ``bench``, ``__graft_entry__`` and pctpu's ``tests``
    made unimportable; so do the benchmark driver, its root shim
    ``bench_torch.py`` and the driver entry."""
    code = (
        "import importlib.abc, importlib.util, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'pctpu', 'bench', 'tests',\n"
        "                                  '__graft_entry__'):\n"
        "            raise ImportError(f'{name} is not importable here')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pctpu_torch, pctpu_torch.ops.cuda_knn\n"
        "import pctpu_torch.cli.batch_top_part_registration\n"
        "import pctpu_torch.cli.batch_whole_registration, pctpu_torch.pipelines.registration\n"
        "import pctpu_torch.cloud, pctpu_torch.ops.icp, pctpu_torch.ops.knn\n"
        "import pctpu_torch.ops.normals2d, pctpu_torch.ops.voxel, pctpu_torch.ops.topflatten\n"
        "import pctpu_torch.ops.transform, pctpu_torch.experiments.registration_ab\n"
        "import pctpu_torch.experiments.icp_ops\n"
        "import pctpu_torch.experiments.wire_ab\n"
        "import pctpu_torch.pipelines.multi_bev, pctpu_torch.cli.batch_multi_bev_gen\n"
        "import pctpu_torch.experiments.scene, pctpu_torch.experiments.bev_ab\n"
        "import pctpu_torch.experiments.segment_sums_probe\n"
        "import pctpu_torch.experiments.bev_raster_probe\n"
        "import pctpu_torch.experiments.nn_fused_probe\n"
        "import pctpu_torch.pipelines.batch_cloud_manip, pctpu_torch.cli.batch_cloud_manip\n"
        "import pctpu_torch.pipelines.cloud_manip, pctpu_torch.cli.cloud_manip\n"
        "import pctpu_torch.ops.render, pctpu_torch.io.html_viewer, pctpu_torch.io.csvfmt\n"
        "import pctpu_torch.io.png, pctpu_torch.experiments.oracle\n"
        "import pctpu_torch.ops.pca, pctpu_torch.ops.pca2d, pctpu_torch.geom.se3\n"
        "import pctpu_torch.cli.pointcloud_pca_test, pctpu_torch.cli.top_part_registration\n"
        "import pctpu_torch.pipelines.selectors, pctpu_torch.io.poses\n"
        "import pctpu_torch.io.kitti, pctpu_torch.io.mulran, pctpu_torch.io.oxford\n"
        "import pctpu_torch.cli.kitti_point_cloud_select\n"
        "import pctpu_torch.cli.kitti_raw_point_cloud_select\n"
        "import pctpu_torch.cli.mulran_point_cloud_select\n"
        "import pctpu_torch.cli.oxford_point_cloud_select\n"
        "import pctpu_torch.parallel, pctpu_torch.parallel.distributed\n"
        "import pctpu_torch.parallel.mesh, pctpu_torch.runtime.profiler\n"
        "import pctpu_torch.experiments.fuzz_campaign, pctpu_torch.experiments.fuzz_scenes\n"
        "import pctpu_torch.experiments.reference_parity\n"
        "import pctpu_torch.experiments.registration_floor\n"
        "import pctpu_torch.experiments.scaling_bench, pctpu_torch.experiments.sort_ordering\n"
        "import pctpu_torch.experiments.bench, pctpu_torch.experiments.graft_entry\n"
        "for name, path in (('torch_end_to_end_demo', 'examples/torch_end_to_end_demo.py'),\n"
        "                   ('torch_library_quickstart', 'examples/torch_library_quickstart.py'),\n"
        "                   ('bench_torch', 'bench_torch.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert pctpu_torch.PCA2D is pctpu_torch.ops.pca2d.PCA2D\n"
        "from pctpu_torch.runtime import native_io\n"
        "assert native_io._lib is None and not native_io._tried\n"
        "from pctpu_torch.ops import _cuda\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'pctpu' or m.startswith('pctpu.') for m in sys.modules)\n"
        "assert _cuda._lib is None\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
