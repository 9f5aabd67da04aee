"""pctpu_torch's registration ops against their pctpu counterparts, on the
CPU: the same numpy inputs (made from a seed) go through both packages.

Bit-equal: c_round, transform_xyz, extract_top_and_flatten (output order
included), voxel_downsample, the nn_1 distances.  Within stated bounds:
normals_2d (1e-5 plus the summation-order bound of its moments, outside the
D3 radius-boundary window), eig2 (1e-6) and ICP (D5 class: torch and XLA
sum in different orders, so transforms within 1e-5 and fitness within 1e-5
relative)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pctpu.cloud as jcloud
from pctpu.config import IcpConfig as JIcpConfig
from pctpu.config import RegistrationConfig as JRegistrationConfig
from pctpu.ops import eig2 as jeig2
from pctpu.ops import icp as jicp
from pctpu.ops import knn as jknn
from pctpu.ops import normals2d as jnormals
from pctpu.ops import rounding as jrounding
from pctpu.ops import topflatten as jtop
from pctpu.ops import transform as jtransform
from pctpu.ops import voxel as jvoxel
from pctpu_torch import from_numpy, registration_config_from
from pctpu_torch.config import IcpConfig
from pctpu_torch.ops import eig2, icp, knn, normals2d, rounding, topflatten
from pctpu_torch.ops import transform, voxel

from .test_icp_differential import _plane_scene, scene


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _scene_cloud(seed, capacity=1536):
    """Clusters (label -2) + ground (label 0) + exact z ties and ±0.0."""
    rng = np.random.default_rng(seed)
    pts, lab = [], []
    for _ in range(8):
        cx, cy = rng.uniform(-95, 95, 2)
        n = int(rng.integers(15, 140))
        z = np.round(rng.uniform(-1, 8, n), 1)  # many equal z
        pts.append(np.stack([cx + rng.normal(0, 3, n), cy + rng.normal(0, 3, n), z], 1))
        lab.append(np.full(n, -2))
    ng = 200
    pts.append(np.stack([rng.uniform(-99, 99, ng), rng.uniform(-99, 99, ng),
                         rng.uniform(-2, -1.9, ng)], 1))
    lab.append(np.zeros(ng))
    xyz = np.concatenate(pts).astype(np.float32)
    xyz[::17, 2] = -0.0
    xyz[1::17, 2] = 0.0
    cloud = jcloud.make_cloud(xyz, label=np.concatenate(lab).astype(np.int32),
                              capacity=capacity)
    return cloud, from_numpy(jcloud.to_numpy(cloud), device="cpu")


def test_from_numpy_and_config_round_trip():
    c_j, c_t = _scene_cloud(0)
    d = jcloud.to_numpy(c_j)
    assert c_t.count == d["count"] and c_t.capacity == len(d["xyz"])
    np.testing.assert_array_equal(c_t.valid_mask().numpy(), np.asarray(c_j.valid_mask()))
    assert c_t.t.dtype == torch.int64
    cfg = JRegistrationConfig(voxel_leaf=0.25,
                              fine=JIcpConfig(max_correspondence_distance=2.0,
                                              max_iterations=7))
    port = registration_config_from(dataclasses.asdict(cfg))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert isinstance(port.fine, IcpConfig)


def test_c_round_bit_equal():
    rng = np.random.default_rng(1)
    v = np.concatenate([
        rng.uniform(-50, 50, 4000),
        np.arange(-20, 20) + 0.5,  # halves round away from zero
        [0.0, -0.0, 0.49999997, -0.49999997, 2.5, -2.5, 1e7 + 0.5],
    ]).astype(np.float32)
    a = np.asarray(jrounding.c_round(jnp.asarray(v)))
    b = rounding.c_round(_t(v)).numpy()
    np.testing.assert_array_equal(_bits(b), _bits(a))


def test_transform_xyz_bit_equal():
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-80, 80, (3000, 3)).astype(np.float32)
    th = 0.37
    m = np.array([[np.cos(th), -np.sin(th), 0.01, 1.5],
                  [np.sin(th), np.cos(th), -0.02, -2.25],
                  [0.003, 0.02, 1.0, 0.1], [0, 0, 0, 1]], np.float32)
    # jitted, as pctpu always runs it: XLA's CPU dot is then the same fma
    # chain as torch's CPU matmul
    a = np.asarray(jax.jit(jtransform.transform_xyz)(jnp.asarray(xyz), jnp.asarray(m)))
    b = transform.transform_xyz(_t(xyz), _t(m)).numpy()
    np.testing.assert_array_equal(_bits(b), _bits(a))


@pytest.mark.parametrize("seed", [3, 4])
def test_extract_top_and_flatten_bit_equal(seed):
    c_j, c_t = _scene_cloud(seed)
    xa, ma, na = (np.asarray(v) for v in jtop.extract_top_and_flatten(c_j))
    xb, mb, nb = topflatten.extract_top_and_flatten(c_t)
    assert int(nb) == int(na) > 0
    np.testing.assert_array_equal(mb.numpy(), ma)
    np.testing.assert_array_equal(_bits(xb.numpy()), _bits(xa))  # order too


@pytest.mark.parametrize("leaf", [0.2, 1.0])
def test_voxel_downsample_bit_equal(leaf):
    c_j, c_t = _scene_cloud(5)
    xyz = np.asarray(c_j.xyz).copy()
    xyz[40:60] = xyz[20:40]  # duplicate points share voxels
    mask = np.asarray(c_j.valid_mask())
    ca, va, na = (np.asarray(v) for v in jvoxel.voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask), leaf))
    cb, vb, nb = voxel.voxel_downsample(_t(xyz), _t(mask), leaf)
    assert int(nb) == int(na)
    np.testing.assert_array_equal(vb.numpy(), va)
    np.testing.assert_array_equal(_bits(cb.numpy()), _bits(ca))


def test_segment_sum_reference_is_sequential():
    """The plain twin of the segment-sum kernel adds each run's rows in row
    order, starting from 0.0."""
    rng = np.random.default_rng(6)
    seg = np.sort(rng.integers(0, 40, 300))
    seg = np.searchsorted(np.unique(seg), seg)  # dense ids 0..k-1
    seg[-25:] = -1  # rows in no segment
    vals = (rng.normal(size=(300, 4)) * 10.0 ** rng.integers(-3, 4, (300, 1))).astype(np.float32)
    got = voxel.segment_sum_sorted(_t(vals), _t(seg)).numpy()
    want = np.zeros((300, 4), np.float32)
    for r in range(300):
        if seg[r] >= 0:
            want[seg[r]] = want[seg[r]] + vals[r]  # f32, in row order
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _run_rows(lengths, gaps, rng, lanes):
    """Segment ids for runs of ``lengths`` rows with ascending, gappy ids and
    ``gaps[k]`` rows of -1 before run k (one more entry: after the last),
    and values spanning 1e-3..1e3 so that the order of the adds changes
    bits."""
    seg, sid = [], 0
    for k, n in enumerate(lengths):
        seg += [-1] * gaps[k] + [sid] * n
        sid += 1 + k % 3  # ids 0, 1, 3, 6, 7, ...: some name no row
    seg = np.array(seg + [-1] * gaps[len(lengths)], np.int32)
    vals = (rng.normal(size=(len(seg), lanes))
            * 10.0 ** rng.integers(-3, 4, (len(seg), 1))).astype(np.float32)
    return vals, seg, sid + 2


def _row_order_loop(vals, seg, init, n_out):
    want = np.tile(np.asarray(init, np.float32), (n_out, 1))
    for r in range(len(seg)):
        if 0 <= seg[r] < n_out:
            want[seg[r]] = want[seg[r]] + vals[r]  # f32, in row order
    return want


SEGMENT_CASES = {
    "tile lengths": ([1, 31, 32, 33, 64, 65, 2000], [0] * 8),
    "outside rows at the front, inside and at the end": ([1, 31, 32, 33, 64, 65, 2000],
                                                         [3, 0, 1, 0, 40, 0, 2, 5]),
    "one segment": ([2000], [0, 0]),
    "one segment between outside rows": ([33], [7, 9]),
    "single rows": ([1] * 70, [0] * 71),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
@pytest.mark.parametrize("lanes,init", [(4, None), (4, (0.5, -2.0, 1e-3, 100.0)),
                                        (2, None), (2, (0.0, 0.01))])
def test_segment_sum_twin_init_and_lanes(case, lanes, init):
    """The twin with 2 and 4 lanes, an initial value and an output size of
    its own against a numpy loop over the rows in order; an id at or past the
    output size joins no segment; and the same sums through an ``order``."""
    rng = np.random.default_rng(11)
    vals, seg, n_out = _run_rows(*SEGMENT_CASES[case], rng, lanes)
    start = (0.0,) * lanes if init is None else init
    want = _row_order_loop(vals, seg, start, n_out)
    got = voxel.segment_sum_sorted(_t(vals), _t(seg), init=init, n_out=n_out).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got[n_out - 1] == np.asarray(start, np.float32)).all()  # named by no row
    cut = max(n_out // 2, 1)  # ids >= cut now join no segment
    got = voxel.segment_sum_sorted(_t(vals), _t(seg), init=init, n_out=cut).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_row_order_loop(vals, seg, start, cut)))
    perm = rng.permutation(len(seg))
    shuffled = np.empty_like(vals)
    shuffled[perm] = vals  # row i of the sums is shuffled[perm[i]]
    got = voxel.segment_sum_sorted(_t(shuffled), _t(seg), init=init, n_out=n_out,
                                   order=_t(perm)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_segment_sum_order_changes_bits():
    """The cases above can tell a sequential sum from another order: summing
    the longest run backwards gives other bits."""
    vals, seg, n_out = _run_rows([2000], [0, 0], np.random.default_rng(11), 4)
    want = _row_order_loop(vals, seg, (0.0,) * 4, n_out)
    back = _row_order_loop(vals[::-1], seg, (0.0,) * 4, n_out)
    assert (_bits(want[0]) != _bits(back[0])).any()


@pytest.mark.parametrize("name", ["make_cloud", "from_numpy", "load_cloud_pcd"])
def test_constructors_default_to_the_card(name):
    """A library user's clouds land on the card unless they ask for the CPU."""
    import inspect

    import pctpu_torch.cloud
    import pctpu_torch.io.pcd

    fn = getattr(pctpu_torch.io.pcd if name == "load_cloud_pcd" else pctpu_torch.cloud, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_eig2():
    rng = np.random.default_rng(7)
    sxx, syy = rng.uniform(0, 50, (2, 500)).astype(np.float32)
    sxy = rng.uniform(-20, 20, 500).astype(np.float32)
    sxx[:5], syy[:5], sxy[:5] = 3.0, 3.0, 0.0  # isotropic → +x fallback
    lj = jeig2.eig2_sym_values(*map(jnp.asarray, (sxx, sxy, syy)))
    lt = eig2.eig2_sym_values(*map(_t, (sxx, sxy, syy)))
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    vj = np.asarray(jeig2.eig2_sym_vector(*map(jnp.asarray, (sxx, sxy, syy)), lj[1]))
    vt = eig2.eig2_sym_vector(*map(_t, (sxx, sxy, syy)), lt[1]).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_array_equal(vt[:5], [[1.0, 0.0]] * 5)


def test_normals_2d():
    rng = np.random.default_rng(8)
    n = 1100
    pts = [np.stack([rng.uniform(-30, 30, 500), 10 + rng.normal(0, 0.05, 500)], 1),
           np.stack([-20 + rng.normal(0, 0.05, 400), rng.uniform(-30, 30, 400)], 1),
           rng.uniform(-60, 60, (200, 2))]
    xy = np.concatenate(pts)
    xyz = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    xyz[7] = xyz[3]  # a coincident pair
    mask = rng.random(n) > 0.05
    r = 2.0
    na, _, oka = (np.asarray(v) for v in jnormals.normals_2d(jnp.asarray(xyz), jnp.asarray(mask), radius=r))
    nb, _, okb = normals2d.normals_2d(_t(xyz), _t(mask), radius=r)
    np.testing.assert_array_equal(okb.numpy(), oka)
    # the two stacks sum the (tile, P) @ (P, 6) moments in different orders;
    # the uncentred moments carry ~n·|p−c|²·2⁻²³ of that rounding, which the
    # minor eigenvector amplifies by 1/(λ₁−λ₀) (the D4 mechanism), so each
    # point is held to 1e-5 plus 4·n·max|p−c|²·2⁻²³/(λ₁−λ₀) of its
    # neighbourhood.  D3: a neighbour within |p−c|²·2⁻²³ (×4) of r² may
    # classify either way in either stack — such points are left out.
    c = 0.5 * (xyz[mask, :2].min(0) + xyz[mask, :2].max(0))
    p = xyz[:, :2].astype(np.float64) - c
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    p2 = (p ** 2).sum(1)
    edge = (np.abs(d2 - r * r) < 4.0 * p2.max() * 2.0**-23)[:, mask].any(1)
    nbr = (d2 < r * r) & mask[None, :]
    tol = np.full(n, 1e-5)
    for i in np.flatnonzero(mask & (nbr.sum(1) >= 3)):
        q = p[nbr[i]]
        ev = np.linalg.eigvalsh(np.cov(q.T, bias=True) * len(q))
        tol[i] += 4.0 * len(q) * p2[nbr[i]].max() * 2.0**-23 / max(ev[1] - ev[0], 1e-30)
    keep = ~edge
    assert keep.sum() > 0.9 * n and np.median(tol[keep & okb.numpy()]) < 5e-4
    err = np.abs(nb.numpy() - na).max(1)
    assert np.all(err[keep] <= tol[keep]), np.max(err[keep] / tol[keep])


def test_nn_1():
    rng = np.random.default_rng(9)
    q = rng.uniform(-40, 40, (700, 3)).astype(np.float32)
    t = rng.uniform(-40, 40, (1500, 3)).astype(np.float32)
    qm = rng.random(700) > 0.1
    tm = rng.random(1500) > 0.1
    ia, da = (np.asarray(v) for v in jknn.nn_1(q, qm, t, tm))
    ib, db = knn.nn_1(_t(q), _t(qm), _t(t), _t(tm))
    ib, db = ib.numpy(), db.numpy()
    assert ib.dtype == np.int32
    assert np.mean(ib[qm] == ia[qm]) > 0.99  # score-window ties may differ
    same = qm & (ib == ia)
    np.testing.assert_array_equal(_bits(db[same]), _bits(da[same]))
    assert np.all(np.isinf(db[~qm]))


def _assert_icp_close(a, b):
    assert bool(b.converged) == bool(a.converged)
    np.testing.assert_allclose(b.transform.numpy(), np.asarray(a.transform), atol=1e-5)
    np.testing.assert_allclose(float(b.fitness), float(a.fitness), rtol=1e-5)


@pytest.mark.parametrize("seed,impl", [(42, "xla"), (43, "xla"), (42, "pruned")])
def test_icp_point_to_point(seed, impl):
    """pctpu's default CPU path (nn_impl auto → xla) against the port's
    brute-force path and its pruned path (the kernel's twin on the CPU)."""
    src, tgt = scene(seed)
    sm, tm = np.ones(len(src), bool), np.ones(len(tgt), bool)
    sm[-5:] = False
    guess = np.eye(4, dtype=np.float32)
    cfg = JIcpConfig(max_correspondence_distance=4.0, max_iterations=12,
                     transformation_epsilon=1e-6, euclidean_fitness_epsilon=0.01)
    a = jicp.icp_point_to_point(src, sm, tgt, tm, guess, cfg)
    b = icp.icp_point_to_point(_t(src), _t(sm), _t(tgt), _t(tm), _t(guess),
                               IcpConfig(**dataclasses.asdict(cfg)), nn_impl=impl)
    _assert_icp_close(a, b)


@pytest.mark.parametrize("seed,impl", [(200, "xla"), (201, "xla"), (200, "pruned")])
def test_icp_point_to_plane(seed, impl):
    src, tgt, nrm, ok = _plane_scene(seed, 5.0, (0.2, -0.1, 0.0))
    sm, tm = np.ones(len(src), bool), np.ones(len(tgt), bool)
    th = np.radians(3.0)
    guess = np.array([[np.cos(th), -np.sin(th), 0, 0.05], [np.sin(th), np.cos(th), 0, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    cfg = JIcpConfig(max_correspondence_distance=10.0, max_iterations=6,
                     point_to_plane=True)
    a = jicp.icp_point_to_plane(src, sm, tgt, tm, nrm, ok, guess, cfg)
    b = icp.icp_point_to_plane(_t(src), _t(sm), _t(tgt), _t(tm), _t(nrm), _t(ok),
                               _t(guess), IcpConfig(**dataclasses.asdict(cfg)),
                               nn_impl=impl)
    _assert_icp_close(a, b)


def test_icp_too_few_correspondences():
    """< 3 correspondences: not converged, the guess kept, as in pctpu."""
    src, tgt = scene(44)
    sm, tm = np.ones(len(src), bool), np.ones(len(tgt), bool)
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 500.0  # nothing within the threshold
    cfg = JIcpConfig(max_correspondence_distance=1.0, max_iterations=5)
    a = jicp.icp_point_to_point(src, sm, tgt, tm, guess, cfg)
    b = icp.icp_point_to_point(_t(src), _t(sm), _t(tgt), _t(tm), _t(guess),
                               IcpConfig(**dataclasses.asdict(cfg)))
    assert not bool(b.converged)
    _assert_icp_close(a, b)
