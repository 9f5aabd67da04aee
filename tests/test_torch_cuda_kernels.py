"""pctpu_torch's CUDA kernels against their plain torch twins, on the card.

One test per kernel, each marked ``cuda``: they skip where there is no
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


@pytest.mark.cuda
def test_segment_sum4(dev):
    rng = np.random.default_rng(7)
    xyz, mask = _cloud(rng, 40000, dev, 30.0)
    values, seg, _ = voxel.voxel_segments(xyz, mask, 0.2)
    assert _bit_equal([voxel.segment_sum_sorted(values, seg)],
                      [voxel.segment_sum_sorted_reference(values, seg)])


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
    values, seg = ground.sector_sums_rows(srow * cfg.grid_cols + scol, ordered.xyz[..., 2], g, cfg)
    assert _bit_equal([voxel.segment_sum_sorted(values, seg, count_as="ground_sums")],
                      [voxel.segment_sum_sorted_reference(values, seg)])
