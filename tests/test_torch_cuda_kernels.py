"""pctpu_torch's CUDA kernels against their plain torch twins, on the card.

Tests per kernel, each marked ``cuda``: they skip where there is no
NVIDIA card (a CUDA kernel has no CPU mode; the twins are held against
pctpu by the other ``test_torch_*`` files).  This file imports neither jax
nor pctpu, so it runs on the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest configures JAX.)  Every kernel must
agree with its twin in every index and every float bit."""

import numpy as np
import pytest
import torch

from pctpu_torch.config import SensorParams
from pctpu_torch.experiments.scene import multi_bev_tree
from pctpu_torch.ops import bev, ground, ordering
from pctpu_torch.ops import cuda_knn as tk
from pctpu_torch.ops import voxel


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cloud(rng, n, dev, span=60.0, drop=0.05):
    xyz = torch.from_numpy(rng.uniform(-span, span, (n, 3)).astype(np.float32)).to(dev)
    return xyz, torch.from_numpy(rng.random(n) >= drop).to(dev)


def _sorted_scene(dev):
    rng = np.random.default_rng(6)
    return (tk.spatial_sort_payload(*_cloud(rng, 20000, dev))
            + tk.spatial_sort_payload(*_cloud(rng, 30000, dev)))


def _bit_equal(got, want) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


@pytest.mark.cuda
def test_nn_pruned(dev):
    args = _sorted_scene(dev)
    for md in (2.0, None):
        assert _bit_equal(tk.nn_1_pruned(*args, max_distance=md),
                          tk.nn_1_pruned_reference(*args, max_distance=md)), md


def _ties(dev):
    """Equal distances across groups and tiles: duplicates of one point at
    indices 5, 40 (another group) and 1500 (another tile), its mirror image
    at 1200."""
    t = torch.full((2100, 3), 50.0)
    t[5] = t[40] = t[1500] = torch.tensor([1.0, 2.0, 3.0])
    t[1200] = torch.tensor([-1.0, -2.0, -3.0])
    q = torch.zeros((37, 3))
    q[1] = torch.tensor([1.0, 2.0, 3.5])
    tm = torch.ones(2100, dtype=torch.bool)
    tm[5] = False
    return q.to(dev), torch.ones(37, dtype=torch.bool, device=dev), t.to(dev), tm.to(dev)


def _warp_cases(dev):
    """(name, (query, query_mask, target, target_mask)) of the warp design's
    edge cases; the sorted ones through spatial_sort_payload."""
    rng = np.random.default_rng(9)
    q, qm, t, tm = _sorted_scene(dev)
    big_t, big_tm = tk.spatial_sort_payload(*_cloud(rng, 300_000, dev, 100.0))
    big_q, big_qm = tk.spatial_sort_payload(*_cloud(rng, 5_000, dev, 100.0))
    ragged = 3 * 1024 + 32 * 5 + 7  # T not a multiple of 32 or 1,024
    return [
        ("sorted", (q, qm, t, tm)),
        ("ties across groups and tiles", _ties(dev)),
        ("all-masked target", (q, qm, t, torch.zeros_like(tm))),
        ("all-masked queries", (q, torch.zeros_like(qm), t, tm)),
        ("Q = 1", (q[:1], torch.ones(1, dtype=torch.bool, device=dev), t, tm)),
        ("Q = 1,000 (not a multiple of 32)", (q[:1000], qm[:1000], t, tm)),
        ("T = 1", (q, qm, t[:1], torch.ones(1, dtype=torch.bool, device=dev))),
        ("T ragged", (q, qm, t[:ragged], tm[:ragged])),
        ("T > 262,144", (big_q, big_qm, big_t, big_tm)),
        ("unsorted", (*_cloud(rng, 3000, dev), *_cloud(rng, 7000, dev))),
        ("queries far outside the target's box", (q + 1000.0, qm, t, tm)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("md", [None, 2.0, 1e-3])
def test_nn_pruned_warp_cases(dev, md):
    """The warp design against its twin, bit for bit, with and without a
    prepared target, and against the earlier block design."""
    for name, args in _warp_cases(dev):
        want = tk.nn_1_pruned_reference(*args, max_distance=md)
        prep = tk.prepare_target(args[2], args[3])
        assert _bit_equal(tk.nn_1_pruned(*args, max_distance=md), want), (name, md)
        assert _bit_equal(tk.nn_1_pruned(*args[:2], max_distance=md, prepared=prep),
                          want), (name, md)
        assert _bit_equal(tk.nn_1_pruned_variant(*args, md, tk.TQ, tk.TT, "prod"), want), (name, md)
        visited = tk.pairs_visited(args[0], args[1], prep, md)
        assert 0 <= visited <= 1024 * -(-args[0].shape[0] // 32) * (prep.packed.shape[0] // 32 + 1)


@pytest.mark.cuda
def test_nn_prep(dev):
    """The prep kernel against its twin: packed points, group and tile boxes,
    bit for bit (−0 coordinates included, and an all-masked group)."""
    rng = np.random.default_rng(10)
    for n in (1, 31, 1024, 5000):
        xyz, mask = _cloud(rng, n, dev)
        xyz[: min(n, 7)] = -0.0
        mask[min(n, 64):min(n, 128)] = False
        got = tk.prepare_target(xyz, mask)
        want = tk.prepare_target_reference(xyz, mask)
        assert got.n == want.n == n
        for a, b in ((got.packed, want.packed), (got.group_box, want.group_box),
                     (got.tile_box, want.tile_box)):
            assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32)), n


@pytest.mark.cuda
def test_nn_variant(dev):
    args = _sorted_scene(dev)
    for tq, tt, mode in sorted(tk.VARIANTS):
        twin = tk.nn_1_pruned_bf16_reference if mode == "bf16" else tk.nn_1_pruned_reference
        for md in (2.0, None):
            assert _bit_equal(tk.nn_1_pruned_variant(*args, md, tq, tt, mode),
                              twin(*args, max_distance=md)), (tq, tt, mode, md)


@pytest.mark.cuda
def test_nn_fused(dev):
    rng = np.random.default_rng(4)
    q, qm = _cloud(rng, 3000, dev, 70.0)
    t, tm = _cloud(rng, 9000, dev, 70.0)
    assert _bit_equal(tk.nn_1_fused(q, qm, t, tm), tk.nn_1_fused_reference(q, qm, t, tm))


def _segment_rows(lengths, gaps, lanes, rng, dev):
    """Runs of ``lengths`` rows under ascending ids (some ids name no row),
    ``gaps[k]`` rows of -1 before run k and ``gaps[-1]`` after the last;
    values spanning 1e-3..1e3, so that the order of the adds changes bits."""
    seg, sid = [], 0
    for k, n in enumerate(lengths):
        seg += [-1] * gaps[k] + [sid] * n
        sid += 1 + k % 3
    seg = np.array(seg + [-1] * gaps[len(lengths)], np.int32)
    vals = (rng.normal(size=(len(seg), lanes))
            * 10.0 ** rng.integers(-3, 4, (len(seg), 1))).astype(np.float32)
    return torch.from_numpy(vals).to(dev), torch.from_numpy(seg).to(dev), sid + 2


def _segment_cases():
    """(name, run lengths, rows of -1 before each run and after the last)."""
    lengths = [1, 31, 32, 33, 64, 65, 2000]
    return [
        ("tile lengths", lengths, [0] * 8),
        ("outside rows at the front, inside and at the end", lengths, [3, 0, 1, 0, 40, 0, 2, 5]),
        # rows 31..64: opens on lane 31 of tile 0, closes on lane 0 of tile 2
        ("from lane 31 to lane 0", [31, 34, 5], [0] * 4),
        ("a run across four tiles, then single rows", [20, 100] + [1] * 40, [0] * 43),
        ("n not a multiple of 32", [7, 50, 3], [0, 0, 0, 1]),
        ("n = 1", [1], [0, 0]),
        ("one row after outside rows", [1], [45, 0]),
        ("all rows outside", [], [77]),
        ("one segment", [5000], [0, 0]),
    ]


def _hold_segment_sums(values, seg, init, n_out, order=None):
    """new = walk = twin, bit for bit, and a second run of the new kernel."""
    want = voxel.segment_sum_sorted_reference(values, seg, init, n_out, order)
    got = voxel.segment_sum_sorted(values, seg, init, n_out, order)
    assert _bit_equal([got], [want])
    assert _bit_equal([voxel.segment_sum_walk(values, seg, init, n_out, order)], [want])
    assert _bit_equal([voxel.segment_sum_sorted(values, seg, init, n_out, order)], [got])


@pytest.mark.cuda
def test_segment_sum4(dev):
    rng = np.random.default_rng(7)
    xyz, mask = _cloud(rng, 40000, dev, 30.0)
    values, seg, _ = voxel.voxel_segments(xyz, mask, 0.2)
    _hold_segment_sums(values, seg, None, None)
    for name, lengths, gaps in _segment_cases():
        for init in (None, (0.5, -2.0, 1e-3, 100.0)):
            values, seg, n_out = _segment_rows(lengths, gaps, 4, rng, dev)
            _hold_segment_sums(values, seg, init, n_out)
            _hold_segment_sums(values, seg, init, max(n_out // 2, 1))  # ids past the output


def _labeled_batch(dev, tmp_path):
    """Four ordered, ground-marked clouds of a small ray-cast drive."""
    from pctpu_torch.io.pcd import load_cloud_pcd

    params = SensorParams(16, 512, 10, 0.5)
    paths = multi_bev_tree(str(tmp_path), params, n_ordered=0, n_raw=4, n_over=0, seed=2)
    clouds = [load_cloud_pcd(p, capacity=params.grid_size + 1024, device=dev) for p in paths]
    batch = clouds[0].replace(
        count=torch.tensor([c.count for c in clouds], device=dev),
        **{k: torch.stack([getattr(c, k) for c in clouds])
           for k in ("xyz", "intensity", "row", "col", "t", "label")})
    return params, ordering.get_ordered_cloud(batch, params)


@pytest.mark.cuda
def test_bev_raster(dev, tmp_path):
    params, ordered = _labeled_batch(dev, tmp_path)
    labeled, _ = ground.mark_ground(ordered, params)
    got = bev.fused_multi_single_bev(labeled, params.height_res)
    want = bev.fused_multi_single_bev_reference(labeled, params.height_res)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[0].count_nonzero()) > 0 and int(got[1].count_nonzero()) > 0


@pytest.mark.cuda
def test_ground_sums(dev, tmp_path):
    params, ordered = _labeled_batch(dev, tmp_path)
    cfg = ground.GroundConfig()
    _, gm = ground.mark_ground(ordered, params)
    g = (gm.reshape(gm.shape[0], -1) == 1)
    srow, scol = ground._belonging_grid(ordered.xyz[..., 0], ordered.xyz[..., 1], cfg)
    values, seg, order = ground.sector_sums_rows(srow * cfg.grid_cols + scol,
                                                 ordered.xyz[..., 2], g, cfg)
    init = (0.0, cfg.count_epsilon)
    n_out = g.shape[0] * cfg.grid_rows * cfg.grid_cols
    assert int((seg < n_out).sum()) == int(g.sum()) > 0
    _hold_segment_sums(values, seg, init, n_out, order)
    rng = np.random.default_rng(8)
    for name, lengths, gaps in _segment_cases():
        values, seg, n_out = _segment_rows(lengths, gaps, 2, rng, dev)
        _hold_segment_sums(values, seg, init, n_out)
        # the same rows, scattered and read through an order
        perm = torch.from_numpy(rng.permutation(seg.shape[0])).to(dev)
        scattered = torch.empty_like(values)
        scattered[perm] = values
        _hold_segment_sums(scattered, seg, init, n_out, perm)
