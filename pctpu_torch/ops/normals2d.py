"""2-D normal estimation by radius neighbourhoods and closed-form 2×2 PCA —
the port of ``pctpu/ops/normals2d.py::normals_2d``.

Reproduces Normal2dEstimation + PCA2D
(reference/src/Normal2dEstimation.cpp:106-190,228-263,
reference/src/PCA2D.cpp:8-42) for z=0 clouds: neighbours include the
point itself; < 2 neighbours → invalid (NaN in the reference); exactly 2 →
perpendicular of (self − other); ≥ 3 → minor eigenvector of the
unnormalised scatter; flipped toward the viewpoint.

Per query tile, a (tile, P) radius mask contracts against the (P, 6) moment
matrix [x, y, x², xy, y², 1] in one full-f32 matmul.  Coordinates are first
shifted by the cloud's bbox centre, which the uncentred-moment scatter needs
for f32 accuracy far from the origin.
"""

from __future__ import annotations

import torch

from pctpu_torch.ops.eig2 import eig2_sym_values, eig2_sym_vector

_BIG = 3e38


def _centered(xyz, mask, viewpoint):
    p2 = xyz[:, :2]
    big = torch.tensor(_BIG, dtype=torch.float32, device=xyz.device)
    mins = torch.where(mask[:, None], p2, big).amin(dim=0)
    maxs = torch.where(mask[:, None], p2, -big).amax(dim=0)
    center = torch.where(maxs >= mins, 0.5 * (mins + maxs), 0.0)
    vx, vy = viewpoint
    return p2 - center, (vx - center[0], vy - center[1])


def _moment_matrix(p2c, mask):
    """(P, 6) per-point moments [x, y, x², x·y, y², 1], masked to zero."""
    x, y = p2c[:, 0], p2c[:, 1]
    moments = torch.stack([x, y, x * x, x * y, y * y, torch.ones_like(x)], dim=1)
    return torch.where(mask[:, None], moments, 0.0)


def _sums_to_normal(sums):
    cnt = torch.clamp_min(sums[:, 5], 1.0)
    mx = sums[:, 0] / cnt
    my = sums[:, 1] / cnt
    sxx = sums[:, 2] - cnt * mx * mx
    sxy = sums[:, 3] - cnt * mx * my
    syy = sums[:, 4] - cnt * my * my
    lam_max, lam_min = eig2_sym_values(sxx, sxy, syy)
    v = eig2_sym_vector(sxx, sxy, syy, lam_min)  # minor eigvec = normal
    curv = lam_min / torch.clamp_min(lam_max + lam_min, 1e-30)
    return v, curv


def _finalize_normals(qt_c, other_c, count_i, v, curv, qm, vpc):
    """2-neighbour perpendicular, coincident-pair gate (exact coordinate
    equality, pctpu normals2d.py:100-101), viewpoint flip, invalid zeroing."""
    seg = qt_c - other_c
    seg_n = torch.linalg.vector_norm(seg, dim=1, keepdim=True)
    seg = seg / torch.clamp_min(seg_n, 1e-30)
    pair_normal = torch.stack([-seg[:, 1], seg[:, 0]], dim=1)

    normal = torch.where((count_i == 2)[:, None], pair_normal, v)
    curv = torch.where(count_i == 2, 0.0, curv)
    coincident = (other_c == qt_c).all(dim=1)
    ok = qm & (count_i >= 2) & ~((count_i == 2) & coincident)

    vp = torch.stack([vpc[0] - qt_c[:, 0], vpc[1] - qt_c[:, 1]], dim=1)
    cos_t = (vp * normal).sum(dim=1)
    normal = torch.where((cos_t < 0)[:, None], -normal, normal)
    normal = torch.where(ok[:, None], normal, 0.0)
    return normal, curv, ok


def normals_2d(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    radius: float = 2.0,
    viewpoint: tuple[float, float] = (0.0, 0.0),
    tile: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (normals (N,3) f32 with z=0, curvature (N,), valid (N,)).

    Neighbour membership uses the expanded |q|² − 2q·t + |t|² distance, as
    pctpu does, with the query's own column set to exactly 0 by index and a
    strict ``d < r²`` (FLANN's radius test).  A neighbour whose true d² lies
    within ~|p−c|²·2⁻²³ of r² can classify differently from an exact test
    (D3), and from pctpu where the two products round differently."""
    n = xyz.shape[0]
    dev = xyz.device
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    p2c, vpc = _centered(xyz, mask, viewpoint)
    moments = _moment_matrix(p2c, mask)
    inf = torch.tensor(float("inf"), device=dev)
    t_sq_masked = torch.where(mask, (p2c * p2c).sum(dim=1), inf)

    normals, curvs, oks = [], [], []
    for base in range(0, n, tile):
        qt = p2c[base : base + tile]
        qm = mask[base : base + tile]
        t = qt.shape[0]
        rows = torch.arange(t, device=dev)
        d = ((qt * qt).sum(dim=1, keepdim=True) - 2.0 * (qt @ p2c.T)) + t_sq_masked[None, :]
        d[rows, base + rows] = 0.0  # exact zero self column, by index
        # STRICT <: nanoflann's RadiusResultSet::addPoint uses dist < radius
        nbr = (d < r2) & qm[:, None]
        sums = nbr.to(torch.float32) @ moments  # (tile, 6)
        v, curv = _sums_to_normal(sums)

        # the 2-neighbour "other" point: nearest neighbour excluding self
        d_no_self = torch.where(nbr, d, inf)
        d_no_self[rows, base + rows] = float("inf")
        other_idx = torch.argmin(d_no_self, dim=1)
        count_i = nbr.sum(dim=1)
        nrm, curv, ok = _finalize_normals(qt, p2c[other_idx], count_i, v, curv, qm, vpc)
        normals.append(nrm)
        curvs.append(curv)
        oks.append(ok)

    normal = torch.cat(normals)
    normals3 = torch.cat([normal, torch.zeros((n, 1), dtype=torch.float32, device=dev)], dim=1)
    return normals3, torch.cat(curvs), torch.cat(oks)
