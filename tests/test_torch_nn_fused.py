"""pctpu_torch's fused unpruned 1-NN against pctpu's Pallas kernel.

The port's plain twin ``nn_1_fused_reference`` (what ``nn_1_fused`` runs for
CPU tensors) is held against ``pctpu.ops.pallas_knn.pallas_nn_1`` in
interpret mode (tq=128, tt=256).  Both pick winners on the score
|t|² − 2q·t, but XLA sums pctpu's K=8 cross term in its own order, so
indices are compared on every row whose best and second-best exact scores
lie more than 4·max|p|²·2⁻²³ apart — and at these seeds that is every row
(the count of closer rows is asserted 0).  Where the indices agree the d²
must be bit-equal.  A numpy f64 brute force checks the winners too.  The
CUDA kernel runs only on a card: ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py`` hold it against the twin there."""

import numpy as np
import pytest
import torch

from pctpu.ops import pallas_knn as pk
from pctpu_torch.ops import cuda_knn as tk


def _clouds(seed, nq=300, nt=700, span=50.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-span, span, (nq, 3)).astype(np.float32)
    t = rng.uniform(-span, span, (nt, 3)).astype(np.float32)
    qm = rng.random(nq) > 0.1
    tm = rng.random(nt) > 0.1
    return q, qm, t, tm


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_ties(q, t, tm):
    """Rows whose two best exact scores |t|² − 2q·t lie within
    4·max|p|²·2⁻²³ (the window in which f32 summation order can move the
    winner)."""
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    score = (t64 ** 2).sum(1)[None, :] - 2.0 * q64 @ t64.T
    score[:, ~tm] = np.inf
    part = np.partition(score, 1, axis=1)
    p2 = max(float((q64 ** 2).sum(1).max()), float((t64 ** 2).sum(1).max()))
    return (part[:, 1] - part[:, 0]) <= 4.0 * p2 * 2.0**-23


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_matches_pallas_nn_1(seed):
    q, qm, t, tm = _clouds(seed)
    i_p, d_p = pk.pallas_nn_1(q, qm, t, tm, tq=128, tt=256, interpret=True)
    i_p, d_p = np.asarray(i_p), np.asarray(d_p)
    i_t, d_t = (a.numpy() for a in tk.nn_1_fused(_t(q), _t(qm), _t(t), _t(tm)))
    assert i_t.dtype == np.int32 and d_t.dtype == np.float32

    assert int(_near_ties(q, t, tm).sum()) == 0
    # every row, masked queries included: pctpu keeps their index too
    np.testing.assert_array_equal(i_t, i_p)
    np.testing.assert_array_equal(d_t.view(np.uint32), d_p.view(np.uint32))
    assert np.all(np.isinf(d_t[~qm])) and np.all(np.isfinite(d_t[qm]))

    # the winners are the exact nearest neighbours (f64 brute force)
    d64 = ((q[:, None, :].astype(np.float64) - t[None].astype(np.float64)) ** 2).sum(-1)
    d64[:, ~tm] = np.inf
    np.testing.assert_array_equal(i_t[qm], d64.argmin(1)[qm])
    np.testing.assert_allclose(d_t[qm], d64.min(1)[qm], rtol=1e-6)


def test_every_target_masked():
    q, qm, t, _ = _clouds(3)
    tm = np.zeros(len(t), bool)
    i_p, d_p = pk.pallas_nn_1(q, qm, t, tm, tq=128, tt=256, interpret=True)
    i_t, d_t = tk.nn_1_fused(_t(q), _t(qm), _t(t), _t(tm))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    assert np.all(i_t.numpy() == 0) and torch.all(torch.isinf(d_t))
    assert np.all(np.isinf(np.asarray(d_p)))


def test_ties_go_to_the_first_index():
    """Duplicate targets: the lowest index wins, masked or not as pctpu
    sees it, and a blocked twin gives the same answer as one block."""
    t = np.full((600, 3), 40.0, np.float32)
    t[7] = t[450] = [1.0, 2.0, 3.0]
    q = np.zeros((5, 3), np.float32)
    q[1] = [1.0, 2.0, 3.5]
    qm = np.ones(5, bool)
    tm = np.ones(600, bool)
    i_p, d_p = pk.pallas_nn_1(q, qm, t, tm, tq=128, tt=256, interpret=True)
    for block in (1 << 23, 600):  # one block, and one query per block
        i_t, d_t = tk.nn_1_fused_reference(_t(q), _t(qm), _t(t), _t(tm), block=block)
        assert i_t.tolist() == [7] * 5 == np.asarray(i_p).tolist()
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_p))
    tm[7] = False
    i_t, _ = tk.nn_1_fused(_t(q), _t(qm), _t(t), _t(tm))
    assert i_t.tolist() == [450] * 5


def test_mirrored_targets_tie_to_the_first():
    """Two targets mirrored about the query score exactly alike from
    different coordinates; the lower index wins in pctpu and in the twin,
    whichever tile it lies in."""
    t = np.full((600, 3), 40.0, np.float32)
    t[300] = [-1.0, -2.0, -3.0]
    t[520] = [1.0, 2.0, 3.0]
    q = np.zeros((4, 3), np.float32)
    qm, tm = np.ones(4, bool), np.ones(600, bool)
    i_p, d_p = pk.pallas_nn_1(q, qm, t, tm, tq=128, tt=256, interpret=True)
    i_t, d_t = tk.nn_1_fused(_t(q), _t(qm), _t(t), _t(tm))
    assert i_t.tolist() == [300] * 4 == np.asarray(i_p).tolist()
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_p))
    tm[300] = False
    assert tk.nn_1_fused(_t(q), _t(qm), _t(t), _t(tm))[0].tolist() == [520] * 4


def _dirty_case(seed=11):
    """One NaN, one +inf and one -inf coordinate in unmasked targets (three
    different 256-tiles, one 2048-tile) and one NaN query."""
    q, _, t, _ = _clouds(seed)
    qm, tm = np.ones(len(q), bool), np.ones(len(t), bool)
    t[100, 1] = np.nan
    t[400, 0] = np.inf
    t[650, 2] = -np.inf
    q[7, 2] = np.nan
    return q, qm, t, tm


def test_nan_and_inf_targets_never_win():
    """A NaN or infinite coordinate makes a NaN score.  The port's rule, for
    twin and kernels alike: a NaN score never wins, so the answer is that of
    the same clouds with those targets masked — which is what pctpu gives
    for the masked-and-zeroed copy.  A NaN query keeps index 0 in both."""
    q, qm, t, tm = _dirty_case()
    i_t, d_t = (a.numpy() for a in tk.nn_1_fused(_t(q), _t(qm), _t(t), _t(tm)))
    clean_t, clean_m = t.copy(), tm.copy()
    clean_t[[100, 400, 650]] = 0.0
    clean_m[[100, 400, 650]] = False
    i_p, d_p = pk.pallas_nn_1(q, qm, clean_t, clean_m, tq=128, tt=256, interpret=True)
    assert int(_near_ties(np.nan_to_num(q), clean_t, clean_m).sum()) == 0
    np.testing.assert_array_equal(i_t, np.asarray(i_p))
    np.testing.assert_array_equal(d_t.view(np.uint32), np.asarray(d_p).view(np.uint32))
    assert i_t[7] == 0 and np.isnan(d_t[7])
    assert not np.isin(i_t[np.arange(len(q)) != 7], [100, 400, 650]).any()
    # blocked twin: the same answer one query a block
    i_b, _ = tk.nn_1_fused_reference(_t(q), _t(qm), _t(t), _t(tm), block=len(t))
    np.testing.assert_array_equal(i_b.numpy(), i_t)


def test_pctpu_answer_on_nan_targets_depends_on_its_tile():
    """Why the port does not follow pctpu there: its per-tile ``jnp.min``
    carries a NaN, so every target of the tile that holds one is lost, and
    the answer changes with ``tt`` (seed 11: all index 0 at tt >= T)."""
    q, qm, t, tm = _dirty_case()
    one_tile = np.asarray(pk.pallas_nn_1(q, qm, t, tm, tq=128, tt=2048, interpret=True)[0])
    small = np.asarray(pk.pallas_nn_1(q, qm, t, tm, tq=128, tt=128, interpret=True)[0])
    assert (one_tile == 0).all()
    assert (small != one_tile).sum() > len(q) // 2


@pytest.mark.parametrize("nt", [1, 511, 512, 700])
def test_prep_twin_matches_plane_layout(nt):
    """The packed target of the fused kernel's prep against pctpu's
    ``_plane_layout``: the coordinates exactly, 3e38 exactly where masked or
    padded, and |t|² to one rounding (pctpu sums x² + y² + z² in XLA's
    order, the port in fma form: at most 2 ulp apart)."""
    rng = np.random.default_rng(nt)
    t = rng.uniform(-50, 50, (nt, 3)).astype(np.float32)
    tm = rng.random(nt) > 0.2
    packed = tk.prepare_fused_target_reference(_t(t), _t(tm)).numpy()
    n_pad = -(-nt // tk.FUSED_TILE) * tk.FUSED_TILE
    assert packed.shape == (n_pad, 4) and packed.dtype == np.float32
    planes = np.asarray(pk._plane_layout(t, tm, n_pad, with_sq=True))
    np.testing.assert_array_equal(packed[:, :3], planes[:3].T)
    big = np.float32(3e38)
    off = np.concatenate([~tm, np.ones(n_pad - nt, bool)])
    assert (packed[off, 3] == big).all() and (planes[3, off] == big).all()
    np.testing.assert_allclose(packed[~off, 3], planes[3, ~off], rtol=2.0**-22)


def test_fused_kernel_needs_cuda_tensors():
    """No fallback: the launchers refuse CPU tensors; only ``nn_1_fused``
    takes the twin, and only because its tensors lie on the CPU."""
    q, qm, t, tm = (_t(a) for a in _clouds(5, 10, 20))
    for fn in (tk.nn_1_fused_v1, tk._fused_launcher, tk._fused_v1_launcher):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, qm, t, tm)
