"""3-D PCA over a filtered cloud (pointcloud_pca_test) — the port of
``pctpu/ops/pca.py``.

Reproduces reference/main.cpp:60-87: filter (z >= 0, planar range <= 30,
label > 0), flatten z = 0, centroid + normalised covariance +
SelfAdjointEigenSolver (eigenvalues ascending, like Eigen and
``jnp.linalg.eigh``).

The eigenvectors' signs are part of the output (the CLI prints them and
draws them as arrows), and LAPACK picks a sign from the last bits of the
covariance: a covariance 1 ulp off flips the middle eigenvector in about a
quarter of flattened clouds.  So the moments are taken in pctpu's own
arithmetic order, as XLA's CPU backend compiles pctpu's jitted ``pca3d``:

* the mean ``sum(xyz · w) / n`` is XLA's tree of reduce-windows: rows are
  summed in windows of 32 (in order, from +0, the padding of
  ``ceil(n/32)·32 − n`` split low = half, high = the rest, padded rows
  skipped), the window sums again in windows of 32, and so on until at
  most 32 remain, which are summed in order from +0 — except that a
  single row is its own sum (XLA drops the reduce of one element);
* each covariance entry is an in-order chain ``acc = fma(d_k[i], d_k[j],
  acc)`` over all rows from +0 (``jnp.matmul`` of dᵀd at HIGHEST precision:
  an elemental loop that LLVM contracts into fmas; a single row is its own
  product), then divided by ``n = max(Σw, 1)``.  Only the
  :func:`live_rows` can change a chain, so kernel and twin run the fmas of
  those alone (a filtered demo cloud keeps ≈ 5% of its rows).

``pca_moments`` computes both on the cloud's device: on the card the hand
kernel ``csrc/pca_moments.cu``, on the CPU its twin
:func:`pca_moments_reference`.  Neither ``torch.matmul`` (on the CPU or
through cuBLAS) nor ``sum`` keeps these orders.

The 3×3 eigensolve runs through LAPACK's ``ssyevd`` on the host (a
36-byte copy) for both devices.  Given the same matrix it is bit-equal to
pctpu's ``jnp.linalg.eigh`` on the CPU, which calls that routine; cuSOLVER
on the card chooses signs of its own.  This is no fallback: all O(N) work
stays on the card, and only the nine numbers go to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from pctpu_torch.cloud import Cloud
from pctpu_torch.ops import _cuda
from pctpu_torch.ops.ground import _horizontal_length
from pctpu_torch.ops.knn import _fma_f32

WINDOW = 32  # XLA's CPU tree-reduction window
# the (i, j) covariance entries the six chains compute; (j, i) mirrors them
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_MIRROR = (0, 1, 2, 1, 3, 4, 2, 4, 5)
_DEFAULT_NAN = -0x400000  # 0xFFC00000, x86's default NaN, as int32
_QUIET = 0x400000


def pca_test_filter(cloud: Cloud) -> tuple[torch.Tensor, torch.Tensor]:
    """The demo's filter (reference/main.cpp:60-74): skip points with
    z < 0 or sqrt(x²+y²) > 30 or label <= 0; flattened to z = 0.

    Expressed as the NEGATED reject condition (not ``z >= 0 & rng <= 30``):
    for NaN coordinates both reference comparisons are false, so the C++
    keeps the point — the equivalent-looking keep-form would drop it."""
    # pctpu's jnp.sqrt(x**2 + y**2), bit for bit
    rng = _horizontal_length(cloud.x, cloud.y)
    keep = ~((cloud.z < 0.0) | (rng > 30.0)) & (cloud.label > 0) & cloud.valid_mask()
    xyz = torch.where(keep[:, None], cloud.xyz, 0.0)
    xyz[:, 2] = 0.0
    return xyz, keep


def _tree_sum(rows: torch.Tensor) -> torch.Tensor:
    """XLA's CPU sum over axis 0 of (n, L) f32 rows (module docstring)."""
    n = rows.shape[0]
    if n == 1:
        return rows[0].clone()
    while rows.shape[0] > WINDOW:
        size = rows.shape[0]
        out = -(-size // WINDOW)
        low = (out * WINDOW - size) // 2
        # a padded row adds +0 to a sum that is never −0: exact, like a skip
        padded = rows.new_zeros((out * WINDOW, rows.shape[1]))
        padded[low:low + size] = rows
        padded = padded.view(out, WINDOW, -1)
        acc = rows.new_zeros((out, rows.shape[1]))
        for k in range(WINDOW):
            acc = acc + padded[:, k]
        rows = acc
    acc = rows.new_zeros((rows.shape[1],))
    for k in range(rows.shape[0]):
        acc = acc + rows[k]
    return acc


def live_rows(xyz: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """The rows whose fmas can change a covariance chain: those where some
    entry of d = (xyz − mu)·w is not ±0, NaN included.  Every other row adds
    an exact ±0 to each chain, and a chain from +0 is never −0, so it stays
    as it was; a one-row cloud's row is always live (its chain starts from
    −0)."""
    if xyz.shape[0] == 1:
        return torch.ones_like(mask)
    d = (xyz - mu) * mask.to(torch.float32)[:, None]
    return (d != 0).any(1)


def scratch_words(n: int) -> int:
    """The 4-byte words of device scratch the kernel takes for n rows (the
    mean's window sums, the counts, the live rows' columns)."""
    return int(_cuda.library().pctpu_pca_moments_scratch_words(n))


def pca_moments_reference(
    xyz: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of the ``pca_moments`` kernel: (mean (3,), covariance
    (3, 3)) of the masked rows in pctpu's arithmetic order (module
    docstring).  Every chain step is :func:`_fma_f32`, correctly rounded; a
    loop over the :func:`live_rows`, vectorised over the six entries — slow
    at a cloud's size, and run only by the tests and the chip check."""
    n = xyz.shape[0]
    w = mask.to(torch.float32)
    count = torch.clamp_min(w.sum(), 1.0)
    mu = _tree_sum(xyz * w[:, None]) / count
    d = (xyz - mu) * w[:, None]
    a = d[:, [i for i, _ in _PAIRS]]
    b = d[:, [j for _, j in _PAIRS]]
    # −0 + x = x for every x: a single row's chain is its own product
    acc = xyz.new_full((6,), -0.0 if n == 1 else 0.0)
    for k in torch.nonzero(live_rows(xyz, mask, mu)).flatten().tolist():
        acc = _fma_f32(a[k], b[k], acc)
    return mu, (acc / count)[list(_MIRROR)].view(3, 3)


def pca_moments(xyz: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean (3,), covariance (3, 3)) of the masked rows of (N, 3) f32
    ``xyz`` in pctpu's arithmetic order.  CUDA tensors launch the kernel
    ``csrc/pca_moments.cu`` (or raise); CPU tensors run the twin."""
    dev = xyz.device
    if dev.type == "cpu":
        return pca_moments_reference(xyz, mask)
    n = xyz.shape[0]
    _cuda.require(xyz, "xyz", torch.float32, (-1, 3), dev)
    _cuda.require(mask, "mask", torch.bool, (n,), dev)
    if n >= 2**24:
        # the count is summed in f32 by pctpu: exact only below 2**24
        raise ValueError(f"pca_moments takes fewer than 2**24 rows, got {n}")
    out = torch.empty(12, dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_words(n), dtype=torch.float32, device=dev)
    rc = _cuda.library().pctpu_pca_moments(
        xyz.data_ptr(), mask.data_ptr(), n, scratch.data_ptr(), out.data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(rc, "pca_moments")
    return out[:3], out[3:].view(3, 3)


def _x86_nan_bits(mu: torch.Tensor, cov: torch.Tensor, xyz: torch.Tensor):
    """The moments (host tensors) with each NaN given the bits pctpu's CPU
    arithmetic gives it when the cloud's NaN coordinates share one bit
    pattern: a mean coordinate takes its column's first NaN, quieted (x86
    passes the first NaN operand on; the card returns one canonical NaN),
    or x86's default NaN where the column holds none (∞ − ∞, ∞·0); a
    covariance entry (i, j) takes mean i's NaN, else mean j's, else the
    default (README D22)."""
    if not bool(torch.isnan(mu).any() | torch.isnan(cov).any()):
        return mu, cov
    default = torch.tensor(_DEFAULT_NAN, dtype=torch.int32).view(torch.float32)
    nan = torch.isnan(xyz)
    first = torch.where(nan.any(0), nan.int().argmax(0), -1).cpu()
    src = xyz[first.clamp_min(0), torch.arange(3, device=xyz.device)].cpu()
    bits = torch.where(first >= 0, (src.view(torch.int32) | _QUIET).view(torch.float32), default)
    mu = torch.where(torch.isnan(mu), bits, mu)
    row, col = torch.isnan(mu)[:, None], torch.isnan(mu)[None, :]
    pick = torch.where(row, bits[:, None], torch.where(col, bits[None, :], default))
    return mu, torch.where(torch.isnan(cov), pick, cov)


def _ssyevd(sym: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LAPACK ``ssyevd`` (lower triangle) of a 3×3 f32 host matrix, as
    pctpu's ``jnp.linalg.eigh`` calls it on the CPU: XLA takes the routine
    from SciPy's LAPACK, so SciPy's binding gives its bits.  (torch's
    ``linalg.eigh`` takes MKL's where torch is built with it: the same on
    flattened clouds, another last bit on 199 of 200 random full 3×3
    matrices.)  NaN where LAPACK reports a failure, as XLA returns."""
    from scipy.linalg import lapack

    vals, vecs, info = lapack.ssyevd(sym.numpy(), compute_v=1, lower=1)
    if info != 0:
        vals, vecs = np.full(3, np.nan, np.float32), np.full((3, 3), np.nan, np.float32)
    return torch.from_numpy(vals), torch.from_numpy(np.ascontiguousarray(vecs))


def pca3d(xyz: torch.Tensor, mask: torch.Tensor):
    """Returns (centroid (3,), eigenvalues ascending (3,), eigenvectors (3,3)
    column-major like Eigen), on the device of ``xyz``."""
    mu, cov = pca_moments(xyz, mask)
    host = torch.cat([mu, cov.flatten()]).cpu()
    mu_h, cov_h = _x86_nan_bits(host[:3], host[3:].view(3, 3), xyz)
    # jnp.linalg.eigh symmetrises its input, (A + Aᵀ)/2, then calls ssyevd
    vals, vecs = _ssyevd((cov_h + cov_h.T) * 0.5)
    dev = xyz.device
    return mu_h.to(dev), vals.to(dev), vecs.to(dev)


def pca_test(cloud: Cloud):
    xyz, keep = pca_test_filter(cloud)
    mu, vals, vecs = pca3d(xyz, keep)
    return mu, vals, vecs, keep.sum(dtype=torch.int32)
