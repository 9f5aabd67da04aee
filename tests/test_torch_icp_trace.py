"""The rest of the registration ops, on the CPU: ``icp_trace`` against
pctpu's trace (per iteration) and against the plain-loop PCL oracle of
``tests/ref_impl.py`` (the cases of ``test_icp_differential.py``), ``knn``,
``normals_2d_knn`` and the ``Normal2dEstimation`` facade against pctpu's.

Windows: the exit iteration must match; per-iteration transforms within
1e-5 of pctpu's and MSEs within 1e-5 relative (the two stacks sum in
different orders, D5), and against the oracle the windows of pctpu's own
differential tests (D8's f32 MSE-plateau class)."""

import numpy as np
import pytest
import torch

from pctpu.config import IcpConfig as JIcpConfig
from pctpu.ops import knn as jknn
from pctpu.ops import normals2d as jnormals
from pctpu.ops.icp import icp_trace as j_icp_trace
from pctpu_torch.config import IcpConfig
from pctpu_torch.ops import icp, knn, normals2d

from . import ref_impl
from .test_icp_differential import assert_traces_match, scene
from .test_l2_api import cloud

_t = torch.from_numpy


def _cfg(cfg: JIcpConfig) -> IcpConfig:
    return IcpConfig(**cfg.__dict__)


def _both(src, tgt, guess, cfg, nrm=None, ok=None):
    """The port's and pctpu's (result, trace as numpy), and the oracle's."""
    sm, tm = np.ones(len(src), bool), np.ones(len(tgt), bool)
    extra = {} if nrm is None else {"tgt_normals": nrm, "normal_mask": ok}
    res, trace = icp.icp_trace(_t(src), _t(sm), _t(tgt), _t(tm), _t(guess), _cfg(cfg),
                               **{k: _t(v) for k, v in extra.items()})
    jres, jtrace = j_icp_trace(src, sm, tgt, tm, guess, cfg, **extra)
    ref = ref_impl.icp_ref(src, tgt, guess, cfg.max_correspondence_distance,
                           cfg.max_iterations, cfg.transformation_epsilon,
                           cfg.euclidean_fitness_epsilon, tgt_normals=nrm, normal_ok=ok)
    return (res, {k: v.numpy() for k, v in trace.items()}), (
        jres, {k: np.asarray(v) for k, v in jtrace.items()}), ref


def _assert_trace_matches_pctpu(trace, jtrace):
    for k in ("done", "converged", "it"):
        np.testing.assert_array_equal(trace[k], jtrace[k], err_msg=k)
    np.testing.assert_allclose(trace["transform"], jtrace["transform"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(trace["mse"], jtrace["mse"], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_to_point_per_iteration(seed):
    src, tgt = scene(seed)
    cfg = JIcpConfig(max_correspondence_distance=4.0, max_iterations=8)
    (res, trace), (jres, jtrace), ref = _both(src, tgt, np.eye(4, dtype=np.float32), cfg)
    _assert_trace_matches_pctpu(trace, jtrace)
    assert_traces_match(trace, ref)
    assert bool(res.converged) == ref["converged"] == bool(jres.converged)
    np.testing.assert_allclose(float(res.fitness), ref["fitness"], rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_point_to_plane_per_iteration(seed):
    """The coarse stage's semantics: point-to-plane LLS on z=0 clouds with
    2-D normals, some targets without one (test_icp_differential's scene)."""
    rng = np.random.default_rng(seed + 10)
    n = 90
    u = rng.uniform(-6, 6, n)
    wall = rng.integers(0, 2, n)
    x = np.where(wall == 0, u, -4.0 + rng.normal(0, 0.01, n))
    y = np.where(wall == 0, 4.0 + rng.normal(0, 0.01, n), u)
    tgt = np.stack([x, y, np.zeros(n)], 1).astype(np.float32)
    nrm = np.where(wall[:, None] == 0, np.float32([[0.0, 1.0, 0.0]]),
                   np.float32([[1.0, 0.0, 0.0]])).astype(np.float32)
    ok = rng.random(n) > 0.1
    th = np.radians(5.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]], np.float32)
    src = (tgt[rng.permutation(n)[:60]] - np.float32([0.3, -0.2, 0.0])) @ rot
    src = (src + rng.normal(0, 0.02, src.shape) * np.float32([1, 1, 0])).astype(np.float32)
    cfg = JIcpConfig(max_correspondence_distance=10.0, max_iterations=4, point_to_plane=True)
    (res, trace), (_, jtrace), ref = _both(src, tgt, np.eye(4, dtype=np.float32), cfg, nrm, ok)
    _assert_trace_matches_pctpu(trace, jtrace)
    assert_traces_match(trace, ref, atol_t=2e-3, rtol_mse=2e-3)
    assert bool(res.converged) == ref["converged"]
    np.testing.assert_allclose(float(res.fitness), ref["fitness"], rtol=2e-3, atol=1e-7)


@pytest.mark.parametrize("impl", ["xla", "pruned"])
def test_trace_matches_production_icp(impl):
    """icp_trace (fixed length, no host read) and icp (early exit) agree
    bit for bit, on both NN paths."""
    src, tgt = scene(7)
    sm, tm = _t(np.ones(len(src), bool)), _t(np.ones(len(tgt), bool))
    guess = _t(np.eye(4, dtype=np.float32))
    cfg = IcpConfig(max_correspondence_distance=4.0, max_iterations=8)
    res_t, trace = icp.icp_trace(_t(src), sm, _t(tgt), tm, guess, cfg, nn_impl=impl)
    res_p = icp.icp_point_to_point(_t(src), sm, _t(tgt), tm, guess, cfg, nn_impl=impl)
    assert torch.equal(res_t.transform, res_p.transform)
    assert torch.equal(res_t.fitness, res_p.fitness)
    assert bool(res_t.converged) == bool(res_p.converged)
    assert trace["transform"].shape == (8, 4, 4) and bool(trace["done"][-1])
    assert torch.equal(trace["transform"][-1], res_t.transform)


def test_max_iterations_zero_do_while():
    """PCL's do-while runs one pass even at max_iterations=0 and reports
    converged by the iterations criterion; port, pctpu and oracle agree."""
    src, tgt = scene(9)
    guess = np.eye(4, dtype=np.float32)
    cfg = JIcpConfig(max_correspondence_distance=4.0, max_iterations=0)
    (res, trace), (_, jtrace), ref = _both(src, tgt, guess, cfg)
    assert len(ref["trace"]) == 1 and ref["converged"] is True
    assert bool(res.converged) and len(trace["it"]) == 1
    assert not np.allclose(res.transform.numpy(), guess)
    _assert_trace_matches_pctpu(trace, jtrace)
    assert_traces_match(trace, ref)


def test_icp_ops_probe_counts_one_iteration(capsys):
    """``experiments.icp_ops`` prints one line for one problem and one for a
    batch of 16, each with the ops of one loop iteration."""
    import json

    from pctpu_torch.experiments import icp_ops

    assert icp_ops.main([]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [line["problems"] for line in lines] == [1, 16]
    for line in lines:
        assert line["ops_per_iteration"] >= line["non_view_ops_per_iteration"] > 0
        assert any(k.startswith("ops/icp.py:") for k in line["top_lines"])


# --- knn ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 40])
def test_knn_matches_pctpu(k):
    """Ragged masks, k beyond the target count (k' = min(k, T), masked
    fill-ins at +inf) and exactly equal distances (duplicate targets: the
    lower index first, as lax.top_k)."""
    rng = np.random.default_rng(k)
    q = rng.uniform(-30, 30, (60, 3)).astype(np.float32)
    t = rng.uniform(-30, 30, (25, 3)).astype(np.float32)
    t[[4, 17]] = t[9]
    q[0] = t[9] + np.float32([0.5, 0.0, 0.0])
    qm, tm = rng.random(60) > 0.1, rng.random(25) > 0.2
    qm[0] = tm[[4, 9, 17]] = True
    ia, da = (np.asarray(v) for v in jknn.knn(q, qm, t, tm, k))
    ib, db = (v.numpy() for v in knn.knn(_t(q), _t(qm), _t(t), _t(tm), k))
    assert ib.shape == ia.shape == (60, min(k, 25)) and ib.dtype == np.int32
    assert np.mean(ib == ia) > 0.99  # the expanded score's tie window
    same = ib == ia
    np.testing.assert_array_equal(db[same].view(np.uint32), da[same].view(np.uint32))
    np.testing.assert_array_equal(ib[0, :3], ia[0, :3])
    if k >= 3:
        assert list(ib[0, :3]) == [4, 9, 17]
    assert np.all(np.isinf(db[~qm]))
    assert knn.nn_1_jit is knn.nn_1


# --- normals_2d_knn and the facade ------------------------------------------

@pytest.mark.parametrize("seed,k", [(0, 5), (1, 9), (2, 2), (3, 30), (8, 50), (4, 1)])
def test_normals_2d_knn_matches_pctpu(seed, k):
    xyz = cloud(seed, n=6 if k == 50 else 120)
    mask = np.ones(len(xyz), bool)
    mask[::11] = False
    na, ca, oka = (np.asarray(v) for v in jnormals.normals_2d_knn(xyz, mask, k))
    nb, cb, okb = (v.numpy() for v in normals2d.normals_2d_knn(_t(xyz), _t(mask), k))
    np.testing.assert_array_equal(okb, oka)
    # the two stacks sum each neighbourhood's moments in other orders, and
    # the minor eigenvector amplifies that by 1/(λ₁−λ₀) (D4): 1e-3, where a
    # well-separated neighbourhood agrees to 1e-6
    np.testing.assert_allclose(nb, na, atol=1e-3)
    if okb.any():
        assert np.median(np.abs(nb - na).max(axis=1)[okb]) < 1e-5
    np.testing.assert_allclose(cb[okb], ca[oka], atol=1e-3)
    if k == 1:
        assert not okb.any()
    ref_n, ref_ok = ref_impl.normals2d_knn_ref(xyz[mask], k)
    np.testing.assert_array_equal(okb[mask], ref_ok)
    for i in np.flatnonzero(ref_ok):
        got = nb[mask][i, :2]
        assert min(np.linalg.norm(got - ref_n[i]), np.linalg.norm(got + ref_n[i])) < 5e-3


def test_normal2d_estimation_errors_match_pctpu():
    for ours, theirs in ((normals2d.Normal2dEstimation(), jnormals.Normal2dEstimation()),):
        for est in (ours, theirs):
            with pytest.raises(RuntimeError, match="set a cloud"):
                est.compute()
            est.set_input_cloud(cloud(6))
            with pytest.raises(RuntimeError, match="either setRadiusSearch or setKSearch !"):
                est.compute()
            est.set_radius_search(2.0)
            est.set_k_search(5)
            with pytest.raises(RuntimeError, match="not both"):
                est.compute()


@pytest.mark.parametrize("mode", ["radius", "k"])
def test_normal2d_estimation_indices_match_pctpu(mode):
    """set_indices restricts both the queries and the searched points; entry
    i belongs to indices[i] and the tail stays zero, as pctpu's facade."""
    xyz = cloud(7)
    idx = np.arange(0, len(xyz), 2)
    outs = []
    for est in (normals2d.Normal2dEstimation(), jnormals.Normal2dEstimation()):
        est.set_input_cloud(xyz)
        est.set_indices(idx)
        est.set_view_point(1.0, -2.0)
        if mode == "k":
            est.set_k_search(5)
        else:
            est.set_radius_search(2.0)
        outs.append([np.asarray(v) for v in est.compute()])
    (nb, cb, okb), (na, ca, oka) = outs
    np.testing.assert_array_equal(okb, oka)
    np.testing.assert_allclose(nb, na, atol=1e-4)
    assert not nb[len(idx):].any() and not okb[len(idx):].any()
    est = normals2d.Normal2dEstimation()
    est.set_input_cloud(xyz)
    est.set_radius_search(2.0)
    direct = normals2d.normals_2d(_t(xyz), _t(np.ones(len(xyz), bool)), radius=2.0)
    for a, b in zip(est.compute(), direct):
        assert torch.equal(a, b)
