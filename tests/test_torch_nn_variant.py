"""The argmin and tile-shape variants of the pruned 1-NN
(``cuda_knn.nn_1_pruned_variant``, the port of ``scripts/exp_nn_argmin.py``)
against pctpu's production Pallas kernel, and the new design's prep
(``cuda_knn.prepare_variant_target``) against pctpu's box planes.

On the CPU a variant (``nn_1_pruned_variant``) runs its mode's twin, which
does not depend on the tile shape.  Each is held against ``pallas_nn_1_pruned(..., kernel="loop",
tq=256, tt=1024, interpret=True)`` on the script's CPU-check scene (seed 5,
1,800 points in a 2,048 bucket, targets = queries + N(0, 0.4 m)).  The exact
modes pick the same winner as pctpu on every query whose best and
second-best d² lie outside pctpu's score window 4·|p|²·2⁻²³, with bit-equal
d² wherever the indices agree; ``bf16`` is held to the script's rule (≥ 90%
of indices agree) and to its own contract on the rounded coordinates.  The
CUDA instances run only on a card (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``)."""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops import pallas_knn as pk
from pctpu_torch.ops import _cuda
from pctpu_torch.ops import cuda_knn as tk
from pctpu_torch.ops.knn import sq_dist

from .test_torch_nn_pruned import _unambiguous

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _scene():
    """exp_nn_argmin.py:80-91, Morton-sorted by pctpu."""
    bucket, n = 2048, 1800
    rng = np.random.default_rng(5)
    q = np.zeros((bucket, 3), np.float32)
    t = np.zeros((bucket, 3), np.float32)
    q[:n] = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    t[:n] = (q[:n] + rng.normal(0, 0.4, (n, 3))).astype(np.float32)
    m = np.arange(bucket) < n
    qs, qsm, _ = pk.spatial_sort(jnp.asarray(q), jnp.asarray(m))
    ts, tsm, _ = pk.spatial_sort(jnp.asarray(t), jnp.asarray(m))
    return tuple(np.asarray(a) for a in (qs, qsm, ts, tsm))


@functools.lru_cache(maxsize=None)
def _pallas(md):
    q, qm, t, tm = _scene()
    i, d = pk.pallas_nn_1_pruned(q, qm, t, tm, max_distance=md, tq=256, tt=1024,
                                 interpret=True, kernel="loop")
    return np.asarray(i), np.asarray(d)


def _t(a):
    return torch.from_numpy(np.array(a))


def _variant(mode, md, tq=256, tt=1024):
    q, qm, t, tm = _scene()
    return tuple(a.numpy() for a in
                 tk.nn_1_pruned_variant(_t(q), _t(qm), _t(t), _t(tm), md, tq, tt, mode))


def _check_exact(i_t, d_t, md):
    """An exact mode's result against pctpu's kernel: the same winner on
    every query outside pctpu's score window, bit-equal d² wherever the
    indices agree, and the production op's result."""
    q, qm, t, tm = _scene()
    i_p, d_p = _pallas(md)
    thr2 = np.inf if md is None else np.float32(md) ** 2
    found = np.isfinite(d_t)
    sure = qm & _unambiguous(q, t, tm)
    assert sure.sum() > 0.99 * qm.sum()
    np.testing.assert_array_equal(i_t[sure & found], i_p[sure & found])
    agree = qm & found & (i_t == i_p)
    np.testing.assert_array_equal(d_t[agree], d_p[agree])
    assert np.all(~found | (d_t <= thr2)) and np.all(np.isinf(d_t[~qm]))
    beyond = qm & ~found  # pctpu: +inf, or a finite d² past the threshold
    assert np.all(~np.isfinite(d_p[beyond]) | (d_p[beyond] > thr2))
    # the exact modes are one contract: the production op's, at every shape
    prod = tk.nn_1_pruned(*map(_t, (q, qm, t, tm)), max_distance=md)
    np.testing.assert_array_equal(i_t, prod[0].numpy())
    np.testing.assert_array_equal(d_t.view(np.uint32), prod[1].numpy().view(np.uint32))


@pytest.mark.parametrize("md", [1.0, None])
@pytest.mark.parametrize("mode", ["prod", "explicit2", "onehot_exact", "onehot_mxu"])
def test_exact_modes_match_pallas(mode, md):
    _check_exact(*_variant(mode, md), md)


def _check_bf16(i_t, d_t, md):
    """The bf16 mode's result against pctpu's kernel by the script's rule,
    and against its own contract."""
    q, qm, t, tm = _scene()
    i_p, d_p = _pallas(md)
    # the script's rule (exp_nn_argmin.py:386-392) on the queries pctpu
    # accepts: its finite d² past the threshold are no correspondence
    valid = np.isfinite(d_p) & (d_p <= (np.inf if md is None else np.float32(md) ** 2))
    assert np.mean(i_t[valid] == i_p[valid]) > 0.90
    # its own contract: the exact winner on bf16-rounded points, ties to the
    # lowest index, and that winner's d² from the f32 points
    rq = q.astype(jnp.bfloat16).astype(np.float32)
    rt = t.astype(jnp.bfloat16).astype(np.float32)
    i_r, d_r = tk.nn_1_pruned_reference(*map(_t, (rq, qm, rt, tm)), max_distance=md)
    np.testing.assert_array_equal(i_t, i_r.numpy())
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_r.numpy()))
    ok = np.isfinite(d_t)
    want = sq_dist(_t(q)[ok] - _t(t)[i_t[ok]]).numpy()
    np.testing.assert_array_equal(d_t[ok], want)


@pytest.mark.parametrize("md", [1.0, None])
def test_bf16_mode(md):
    _check_bf16(*_variant("bf16", md), md)


VARIANTS = sorted(tk.VARIANTS)
VARIANT_TTS = sorted({tt for _, tt in tk.VARIANT_TILES})


@pytest.mark.parametrize("md", [1.0, None])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_every_instance_matches_pallas(variant, md):
    """Each compiled (tq, tt, mode), as the CPU runs it, against pctpu's
    loop kernel under the rules above (its mode's rule)."""
    tq, tt, mode = variant
    got = _variant(mode, md, tq, tt)
    (_check_bf16 if mode == "bf16" else _check_exact)(*got, md)


@pytest.mark.parametrize("md", [1.0, None])
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: "-".join(map(str, v)))
def test_cpu_runs_the_modes_twin(variant, md):
    """On CPU tensors the wrapper runs its mode's twin
    (``nn_1_pruned_reference``, or ``nn_1_pruned_bf16_reference`` for
    ``bf16``), bit for bit: the identity the card tests hold the kernel to."""
    q, qm, t, tm = map(_t, _scene())
    got = tk.nn_1_pruned_variant(q, qm, t, tm, md, *variant)
    twin = tk.nn_1_pruned_bf16_reference if variant[2] == "bf16" else tk.nn_1_pruned_reference
    for x, y in zip(got, twin(q, qm, t, tm, md)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _masked_tiles_scene():
    """9,000 points, 1,000 of them padding, with whole 1,024- and 4,096-point
    tiles, a group and single points masked, and −0 coordinates."""
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-60, 60, (9000, 3)).astype(np.float32)
    xyz[:5] = -0.0
    xyz[40, 1] = -0.0
    m = np.ones(9000, bool)
    m[1024:2048] = False
    m[4096:8192] = False
    m[300:332] = False
    m[8000:] = False
    m[17] = False
    return xyz, m


@pytest.mark.parametrize("scene", ["cpu_check", "masked_tiles"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("tt", VARIANT_TTS)
def test_variant_prep_boxes_equal_pctpu(tt, bf16, scene):
    """The new design's prep twin (``prepare_target_reference(..., tile=tt,
    bf16=)``, the CPU path of ``prepare_variant_target``): its group and
    tile boxes equal pctpu's ``_tile_bboxes`` over 32 and tt points of the
    target (bf16-rounded for bf16), the impossible box (3e38, −3e38) for a
    tile or group with no valid point, −0 equal to +0."""
    xyz, m = (_scene()[2:] if scene == "cpu_check" else _masked_tiles_scene())
    prep = tk.prepare_target_reference(_t(xyz), _t(m), tt, bf16)
    if (tt, bf16) in tk.VARIANT_PREPS:  # a compiled prep: its CPU path is the twin
        same = tk.prepare_variant_target(_t(xyz), _t(m), tt, bf16)
        for a, b in ((same.packed, prep.packed), (same.group_box, prep.group_box),
                     (same.tile_box, prep.tile_box)):
            assert torch.equal(a, b)
    else:
        with pytest.raises(ValueError, match="no compiled instance"):
            tk.prepare_variant_target(_t(xyz), _t(m), tt, bf16)
    n_pad = -(-len(xyz) // tt) * tt
    pts = xyz.astype(jnp.bfloat16).astype(np.float32) if bf16 else xyz
    pad_x = np.zeros((n_pad, 3), np.float32)
    pad_x[:len(xyz)] = pts
    pad_m = np.zeros(n_pad, bool)
    pad_m[:len(xyz)] = m
    for got, tile in ((prep.group_box, 32), (prep.tile_box, tt)):
        want = np.asarray(pk._tile_bboxes(jnp.asarray(pad_x), jnp.asarray(pad_m), tile))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        assert not np.signbit(got.numpy()[got.numpy() == 0]).any()  # −0 stored as +0
    assert prep.n == len(xyz) and prep.packed.shape == (n_pad, 4)
    empty = ~pad_m.reshape(-1, tt).any(axis=1)
    if scene == "masked_tiles":
        assert empty.any()
    np.testing.assert_array_equal(prep.tile_box.numpy()[:3, empty], np.float32(3e38))
    np.testing.assert_array_equal(prep.tile_box.numpy()[3:6, empty], np.float32(-3e38))


@pytest.mark.parametrize("tt", VARIANT_TTS)
def test_variant_bf16_packing(tt):
    """The bf16 prep twin's packed target (the compiled bf16 instances'
    prep takes tt 1,024; the twin any tt): a bfloat16 (⌈T / tt⌉·tt, 4) tensor
    holding ``cuda_knn._bf16`` of each valid point, +inf for masked and
    padding points, 0 in the fourth column — 8 bytes a point."""
    xyz, m = map(_t, _masked_tiles_scene())
    packed = tk.prepare_target_reference(xyz, m, tt, bf16=True).packed
    n_pad = -(-len(xyz) // tt) * tt
    assert packed.dtype == torch.bfloat16 and packed.shape == (n_pad, 4)
    assert packed.element_size() * packed.shape[1] == 8
    wide = packed.to(torch.float32)
    valid = torch.zeros(n_pad, dtype=torch.bool)
    valid[:len(xyz)] = m
    assert torch.equal(wide[:len(xyz)][m, :3].view(torch.int32),
                       tk._bf16(xyz[m]).view(torch.int32))
    assert bool(torch.isposinf(wide[~valid, :3]).all())
    assert bool((wide[:, 3] == 0).all())
    f32 = tk.prepare_target_reference(xyz, m, tt).packed
    assert f32.dtype == torch.float32 and torch.equal(f32[:len(xyz)][m, :3], xyz[m])


def test_variants_are_the_compiled_set():
    assert (128, 1024, "prod") in tk.VARIANTS and len(tk.VARIANTS) == 13
    assert {tt for _, tt, _ in tk.VARIANTS} == {1024, 2048, 4096}
    # the build instantiates the same list the wrapper accepts
    header = _cuda._instances_header()
    assert all(f"X({tq}, {tt}, {tk.MODES[m]})" in header for tq, tt, m in tk.VARIANTS)
    assert header.count("X(") == len(_cuda.NN_INSTANCES) == 12
    q, qm, t, tm = _scene()
    a = tk.nn_1_pruned_variant(*map(_t, (q, qm, t, tm)), 1.0, 512, 4096, "prod")
    b = tk.nn_1_pruned_variant(*map(_t, (q, qm, t, tm)), 1.0, 256, 1024, "onehot_mxu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for bad in ((512, 1024, "bf16"), (64, 1024, "prod"), (256, 1024, "high3")):
        with pytest.raises(ValueError, match="not compiled"):
            tk.nn_1_pruned_variant(*map(_t, (q, qm, t, tm)), 1.0, *bad)


def test_variant_preps_are_the_compiled_tiles():
    """One prep for each tile of the instances, and a bf16 prep only where a
    bf16 instance has that tile; any other (tt, bf16) raises ValueError."""
    assert tk.VARIANT_PREPS == {(1024, False), (2048, False), (4096, False), (1024, True)}
    xyz, m = map(_t, _masked_tiles_scene())
    for tt, bf16 in ((512, False), (2048, True), (4096, True)):
        with pytest.raises(ValueError, match="no compiled instance"):
            tk.prepare_variant_target(xyz, m, tt, bf16)


def test_cpu_check_imports_no_jax():
    """``python -m pctpu_torch.experiments.nn_argmin --cpu-check`` passes
    without pulling in jax or pctpu."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['nn_argmin', '--cpu-check']\n"
        "try:\n"
        "    runpy.run_module('pctpu_torch.experiments.nn_argmin', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'pctpu' or m.startswith('pctpu.') for m in sys.modules)\n"
        "import pctpu_torch.cli.batch_whole_registration, pctpu_torch.ops.cuda_knn\n"
        "assert 'jax' not in sys.modules\n"
        "from pctpu_torch.ops import _cuda\n"
        "assert _cuda._lib is None\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == '{"cpu_check_ok": true}'
    assert sum('"cpu_check"' in line for line in lines) == 10
