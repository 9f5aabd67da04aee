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


def test_port_imports_no_jax():
    """Importing the port pulls in neither jax nor pctpu, and builds
    nothing: the CUDA library is compiled at first launch only."""
    code = (
        "import sys\n"
        "import pctpu_torch, pctpu_torch.ops.cuda_knn\n"
        "import pctpu_torch.cli.batch_top_part_registration\n"
        "import pctpu_torch.pipelines.multi_bev, pctpu_torch.cli.batch_multi_bev_gen\n"
        "import pctpu_torch.experiments.scene\n"
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
