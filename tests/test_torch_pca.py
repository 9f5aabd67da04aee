"""pointcloud_pca_test and PCA2D of pctpu_torch against pctpu's, on the CPU.

The filter must keep the same points (NaN coordinates kept, the 30 m edge
on the same side) bit for bit; the moments' twin
(``pca_moments_reference``, the plain version of ``csrc/pca_moments.cu``)
must equal pctpu's jitted mean and covariance bit for bit — XLA's CPU tree
of reduce-windows and its in-order fma chain — and so must ``pca3d``'s
centroid, eigenvalues and eigenvectors, signs included; the CLI's standard
output, both snapshot views and the HTML viewer must be byte-equal to
pctpu's.  PCA2D is held to pctpu's own tolerances
(``tests/test_l2_api.py:85-124``): mean 1e-5, eigenvalues rtol 1e-4 / atol
1e-3, eigenvectors up to sign within 1e-3 (it sums in torch's order)."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pctpu.cli.pointcloud_pca_test as jcli
from pctpu.cloud import make_cloud as jmake_cloud
from pctpu.io.pcd import save_cloud_pcd
from pctpu.ops import pca as jpca
from pctpu.ops.pca2d import PCA2D as JPCA2D
from pctpu_torch import make_cloud
from pctpu_torch.cli import pointcloud_pca_test as tcli
from pctpu_torch.ops import pca as tpca
from pctpu_torch.ops.pca2d import PCA2D

from . import ref_impl


@jax.jit
def _pctpu_moments(xyz, mask):
    """pctpu/ops/pca.py:38-43: the mean and covariance pca3d hands to eigh."""
    w = mask.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(xyz * w[:, None], axis=0) / n
    d = (xyz - mu) * w[:, None]
    return mu, jnp.matmul(d.T, d, precision=jax.lax.Precision.HIGHEST) / n


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _cloud_xyz(rng, n, flat=False):
    xyz = (rng.normal(size=(n, 3)) * rng.uniform(0.5, 40.0, 3)).astype(np.float32)
    if flat:
        xyz[:, 2] = 0.0
    return xyz


@pytest.mark.parametrize("n", [1, 2, 5, 31, 32, 33, 100, 1024, 1025, 4097])
@pytest.mark.parametrize("masking", ["random", "none kept", "all kept"])
def test_moments_twin_matches_pctpu_bit_for_bit(n, masking):
    """The twin's mean (XLA's reduce-window tree, a single row its own sum)
    and covariance (the in-order fma chain) equal pctpu's jitted ones in
    every bit, signed zeros included."""
    rng = np.random.default_rng(n)
    xyz = _cloud_xyz(rng, n)
    mask = {"random": rng.random(n) < 0.7, "none kept": np.zeros(n, bool),
            "all kept": np.ones(n, bool)}[masking]
    want = _pctpu_moments(jnp.asarray(xyz), jnp.asarray(mask))
    got = tpca.pca_moments(torch.from_numpy(xyz), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_moments_and_pca3d_bit_equal_at_a_clouds_size(seed):
    """At an HDL-64E cloud's 133,312 slots (three levels of the mean's
    tree, the dot at the demo's size), about 5% of the rows kept and the
    rest zeroed and flattened as the demo's filter leaves them: the twin's
    moments equal pctpu's jitted ones, and ``pca3d``'s centroid, eigenvalues
    and eigenvectors pctpu's, bit for bit."""
    rng = np.random.default_rng(20 + seed)
    n = 64 * 2083
    xyz = _cloud_xyz(rng, n, flat=True)
    mask = rng.random(n) < 0.053
    xyz[~mask] = 0.0
    want = _pctpu_moments(jnp.asarray(xyz), jnp.asarray(mask))
    got = tpca.pca_moments(torch.from_numpy(xyz), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    got = tpca.pca3d(torch.from_numpy(xyz), torch.from_numpy(mask))
    want = jpca.pca3d(jnp.asarray(xyz), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_live_rows():
    """The rows the chains run over: some entry of d = (xyz − mu)·w not
    ±0, NaN included (a masked NaN or ±inf row stays live), and the one row
    of a one-row cloud whatever it holds."""
    xyz = torch.tensor([[1.0, 0.0, 0.0], [2.0, 2.0, 0.0], [float("nan"), 0.0, 0.0],
                        [float("inf"), 0.0, 0.0], [5.0, 5.0, 0.0], [2.0, 2.0, -0.0]])
    mask = torch.tensor([True, True, False, False, False, True])
    mu = torch.tensor([2.0, 2.0, 0.0])
    assert tpca.live_rows(xyz, mask, mu).tolist() == [True, False, True, True, False, False]
    assert tpca.live_rows(xyz[:1], torch.zeros(1, dtype=torch.bool), mu).tolist() == [True]


def test_moments_nan_rows():
    """NaN coordinates reach the moments (NaN·0 is NaN): the same entries
    are NaN in both packages, and pca3d gives the NaNs pctpu's bits."""
    rng = np.random.default_rng(3)
    xyz = _cloud_xyz(rng, 300, flat=True)
    xyz[17, 0] = np.nan
    xyz[40, 1] = np.nan
    mask = rng.random(300) < 0.8
    want_mu, want_cov = _pctpu_moments(jnp.asarray(xyz), jnp.asarray(mask))
    mu, cov = tpca.pca_moments(torch.from_numpy(xyz), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.isnan(mu.numpy()), np.isnan(np.asarray(want_mu)))
    np.testing.assert_array_equal(np.isnan(cov.numpy()), np.isnan(np.asarray(want_cov)))
    got = tpca.pca3d(torch.from_numpy(xyz), torch.from_numpy(mask))
    want = jpca.pca3d(jnp.asarray(xyz), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("flat", [True, False])
def test_pca3d_bit_equal_over_clouds(flat):
    """60 clouds: every centroid, eigenvalue and eigenvector bit-equal to
    pctpu's, so no eigenvector's sign differs (0 of 60; a covariance 1 ulp
    off flips the middle one in about a quarter of flattened clouds)."""
    rng = np.random.default_rng(8 + flat)
    flips = 0
    for _ in range(60):
        n = int(rng.integers(50, 700))
        xyz = _cloud_xyz(rng, n, flat=flat)
        mask = rng.random(n) < 0.9
        got = tpca.pca3d(torch.from_numpy(xyz), torch.from_numpy(mask))
        want = jpca.pca3d(jnp.asarray(xyz), jnp.asarray(mask))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        flips += int((np.sign(got[2].numpy()) != np.sign(np.asarray(want[2]))).any())
    assert flips == 0


def _edge_cloud(rng):
    """Points on and beside the 30 m planar edge (exact and 1 ulp off), NaN
    coordinates, z < 0, −0, non-positive labels and padding."""
    ang = rng.uniform(0, 2 * np.pi, 400)
    r = np.float32(30.0) + rng.integers(-3, 4, 400).astype(np.float32) * np.float32(2e-6)
    xyz = np.stack([r * np.cos(ang), r * np.sin(ang), rng.uniform(-1, 3, 400)], 1)
    xyz = np.concatenate([xyz.astype(np.float32), _cloud_xyz(rng, 200)])
    xyz[:4] = [[30.0, 0.0, 1.0], [0.0, -30.0, 1.0], [18.0, 24.0, 0.5], [-0.0, 30.0, -0.0]]
    xyz[5, 0] = xyz[6, 1] = xyz[7, 2] = np.nan
    label = rng.integers(-2, 3, len(xyz)).astype(np.int32)
    label[:8] = 1
    return xyz, label


def test_filter_matches_pctpu():
    xyz, label = _edge_cloud(np.random.default_rng(4))
    want_xyz, want_keep = jpca.pca_test_filter(jmake_cloud(xyz, label=label, capacity=700))
    got_xyz, got_keep = tpca.pca_test_filter(
        make_cloud(xyz, label=label, capacity=700, device="cpu"))
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
    np.testing.assert_array_equal(_bits(got_xyz.numpy()), _bits(want_xyz))
    keep = got_keep.numpy()
    assert keep[[0, 1, 2, 3, 5, 6, 7]].all()  # the 30 m points and the NaN rows
    assert not keep[600:].any()  # padding
    near = np.abs(np.hypot(xyz[8:400, 0], xyz[8:400, 1]) - 30.0) < 1e-5
    assert keep[8:400][near].any() and not keep[8:400][near].all()


def test_pca_test_matches_pctpu():
    xyz, label = _edge_cloud(np.random.default_rng(5))
    want = jpca.pca_test(jmake_cloud(xyz, label=label))
    got = tpca.pca_test(make_cloud(xyz, label=label, device="cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.numpy()).view(np.int32),
                                      np.asarray(w).view(np.int32))


def _run_cli(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert main(args) == 0
    return out.getvalue()


@pytest.mark.parametrize("scene", ["demo", "edge", "nan"])
def test_cli_matches_pctpu(tmp_path, scene):
    """Standard output, both snapshot views and the HTML viewer byte-equal
    to pctpu's CLI (the demo cloud of tests/test_render.py, the 30 m edge
    cloud, and a cloud with NaN coordinates — NaN arrows, which both
    packages' snapshot cannot draw (``segment_points`` takes their length),
    so that cloud is compared without ``--snapshot``)."""
    rng = np.random.default_rng(4)
    if scene == "demo":
        n = 400
        xyz = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                        rng.uniform(0.5, 4.0, n)], 1).astype(np.float32)
        label = np.ones(n, np.int32)
    else:
        xyz, label = _edge_cloud(rng)
        if scene == "edge":
            xyz[5:8] = 1.0
    pcd = str(tmp_path / "in.pcd")
    save_cloud_pcd(pcd, jmake_cloud(xyz, label=label))
    for view in ("top", "front"):
        outs = {}
        for name, main, extra in (("pctpu", jcli.main, []),
                                  ("port", tcli.main, ["--device=cpu"])):
            png, html = tmp_path / f"{name}.png", tmp_path / f"{name}.html"
            snap = [] if scene == "nan" else [f"--snapshot={png}", f"--snapshot-view={view}"]
            stdout = _run_cli(main, [pcd, *snap, f"--html={html}", *extra])
            outs[name] = (stdout, png.read_bytes() if snap else b"", html.read_bytes())
        assert outs["port"][0] == outs["pctpu"][0]
        assert outs["port"][0].startswith(f"cloud_in: {len(xyz)}, filter: ")
        assert outs["port"][1] == outs["pctpu"][1], view
        assert outs["port"][2] == outs["pctpu"][2]


def test_cli_needs_a_card_unless_asked(tmp_path, monkeypatch, capsys):
    pcd = str(tmp_path / "in.pcd")
    save_cloud_pcd(pcd, jmake_cloud(np.ones((4, 3), np.float32), label=np.ones(4, np.int32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tcli.main([pcd])
    assert exc.value.code == 2
    assert "--device=cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        tcli.main([])
    assert exc.value.code == 1


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("use_indices", [False, True])
def test_pca2d_fit_matches_pctpu_and_oracle(seed, use_indices):
    from .test_l2_api import cloud

    xyz = cloud(seed + 20)
    rng = np.random.default_rng(seed)
    indices = np.sort(rng.choice(len(xyz), 60, replace=False)) if use_indices else None
    ref_mean, ref_w, ref_v = ref_impl.pca2d_ref(xyz, indices)
    jp = JPCA2D()
    jp.set_input_cloud(xyz)
    jp.set_indices(indices)
    pca = PCA2D(device="cpu")
    pca.set_input_cloud(xyz)
    pca.set_indices(indices)
    for want_mean, want_w, want_v in (
            (ref_mean, ref_w, ref_v),
            (np.asarray(jp.get_mean()), np.asarray(jp.get_eigen_values()),
             np.asarray(jp.get_eigen_vectors()))):
        np.testing.assert_allclose(pca.get_mean().numpy(), want_mean, atol=1e-5)
        np.testing.assert_allclose(pca.get_eigen_values().numpy(), want_w,
                                   rtol=1e-4, atol=1e-3)
        v = pca.get_eigen_vectors().numpy()
        for col in range(2):
            d = min(np.linalg.norm(v[:, col] - want_v[:, col]),
                    np.linalg.norm(v[:, col] + want_v[:, col]))
            assert d < 1e-3


def test_pca2d_project_matches_pctpu():
    from .test_l2_api import cloud

    xyz = cloud(30)
    pca, jp = PCA2D(device="cpu"), JPCA2D()
    pca.set_input_cloud(xyz)
    jp.set_input_cloud(xyz)
    proj = pca.project(xyz).numpy()
    assert proj.shape == (len(xyz), 3) and np.all(proj[:, 2] == 0.0)
    v, mean = pca.get_eigen_vectors().numpy(), pca.get_mean().numpy()
    np.testing.assert_allclose(proj[:, :2] @ v.T + mean, xyz[:, :2], atol=1e-4)
    # up to the sign of each axis, pctpu's projection
    want = np.asarray(jp.project(xyz))
    signs = np.sign(np.sum(proj[:, :2] * want[:, :2], axis=0))
    np.testing.assert_allclose(proj[:, :2] * signs, want[:, :2], atol=1e-3)
    # a tensor input is used where it lies
    assert pca.project(torch.from_numpy(xyz[:3])).shape == (3, 3)


def test_pca2d_requires_cloud_and_defaults_to_the_card():
    with pytest.raises(RuntimeError):
        PCA2D(device="cpu").get_mean()
    assert PCA2D().device == torch.device("cuda")
