"""The argmin and tile-shape variants of the pruned 1-NN
(``cuda_knn.nn_1_pruned_variant``, the port of ``scripts/exp_nn_argmin.py``)
against pctpu's production Pallas kernel.

On the CPU a variant runs its mode's twin, which does not depend on the
tile shape.  Each is held against ``pallas_nn_1_pruned(..., kernel="loop",
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


@pytest.mark.parametrize("md", [1.0, None])
@pytest.mark.parametrize("mode", ["prod", "explicit2", "onehot_exact", "onehot_mxu"])
def test_exact_modes_match_pallas(mode, md):
    q, qm, t, tm = _scene()
    i_p, d_p = _pallas(md)
    i_t, d_t = _variant(mode, md)
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
def test_bf16_mode(md):
    q, qm, t, tm = _scene()
    i_p, d_p = _pallas(md)
    i_t, d_t = _variant("bf16", md)
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
