"""2-D normal estimation by radius or k-nearest neighbourhoods and
closed-form 2×2 PCA — the port of ``pctpu/ops/normals2d.py``.

Reproduces Normal2dEstimation + PCA2D
(reference/src/Normal2dEstimation.cpp:106-190,228-263,
reference/src/PCA2D.cpp:8-42) for z=0 clouds: neighbours include the
point itself; < 2 neighbours → invalid (NaN in the reference); exactly 2 →
perpendicular of (self − other); ≥ 3 → minor eigenvector of the
unnormalised scatter; flipped toward the viewpoint.

Per query tile, a (tile, P) radius mask contracts against the (P, 6) moment
matrix [x, y, x², xy, y², 1] in one full-f32 matmul.  Coordinates are first
shifted by the cloud's bbox centre, which the uncentred-moment scatter needs
for f32 accuracy far from the origin.  :func:`normals_2d` also takes a batch
of clouds (B, N, 3), as pctpu's under ``jax.vmap``: the tile loop carries B
inside it, its two products as ``torch.bmm``.
"""

from __future__ import annotations

import numpy as np
import torch

from pctpu_torch.ops.eig2 import eig2_sym_values, eig2_sym_vector

_BIG = 3e38


def _centered(xyz, mask, viewpoint):
    """(B, N, 2) coordinates and the (B, 2) viewpoint, shifted by each cloud's
    valid-point bbox centre."""
    p2 = xyz[..., :2]
    mins = torch.where(mask[..., None], p2, _BIG).amin(dim=-2)
    maxs = torch.where(mask[..., None], p2, -_BIG).amax(dim=-2)
    center = torch.where(maxs >= mins, 0.5 * (mins + maxs), 0.0)
    vx, vy = viewpoint
    return p2 - center[:, None, :], torch.stack([vx - center[:, 0], vy - center[:, 1]], dim=-1)


def _moment_matrix(p2c, mask):
    """(B, P, 6) per-point moments [x, y, x², x·y, y², 1], masked to zero."""
    x, y = p2c[..., 0], p2c[..., 1]
    moments = torch.stack([x, y, x * x, x * y, y * y, torch.ones_like(x)], dim=-1)
    return torch.where(mask[..., None], moments, 0.0)


def _sums_to_normal(sums):
    cnt = torch.clamp_min(sums[..., 5], 1.0)
    mx = sums[..., 0] / cnt
    my = sums[..., 1] / cnt
    sxx = sums[..., 2] - cnt * mx * mx
    sxy = sums[..., 3] - cnt * mx * my
    syy = sums[..., 4] - cnt * my * my
    lam_max, lam_min = eig2_sym_values(sxx, sxy, syy)
    v = eig2_sym_vector(sxx, sxy, syy, lam_min)  # minor eigvec = normal
    curv = lam_min / torch.clamp_min(lam_max + lam_min, 1e-30)
    return v, curv


def _finalize_normals(qt_c, other_c, count_i, v, curv, qm, vpc):
    """2-neighbour perpendicular, coincident-pair gate (exact coordinate
    equality, pctpu normals2d.py:100-101), viewpoint flip, invalid zeroing.
    Tiles (B, t, ·), ``vpc`` (B, 2)."""
    seg = qt_c - other_c
    seg_n = torch.linalg.vector_norm(seg, dim=-1, keepdim=True)
    seg = seg / torch.clamp_min(seg_n, 1e-30)
    pair_normal = torch.stack([-seg[..., 1], seg[..., 0]], dim=-1)

    normal = torch.where((count_i == 2)[..., None], pair_normal, v)
    curv = torch.where(count_i == 2, 0.0, curv)
    coincident = (other_c == qt_c).all(dim=-1)
    ok = qm & (count_i >= 2) & ~((count_i == 2) & coincident)

    vp = vpc[:, None, :] - qt_c
    cos_t = (vp * normal).sum(dim=-1)
    normal = torch.where((cos_t < 0)[..., None], -normal, normal)
    normal = torch.where(ok[..., None], normal, 0.0)
    return normal, curv, ok


def _tile_dist2(qt, base, p2c, t_sq_masked):
    """Expanded |q|² − 2q·t + |t|² of a (B, t, 2) query tile against every
    point, with the query's own column set to exactly 0 by index."""
    d = ((qt * qt).sum(dim=-1, keepdim=True) - 2.0 * torch.bmm(qt, p2c.transpose(1, 2))) \
        + t_sq_masked[:, None, :]
    _self_column(d, base).fill_(0.0)
    return d


def _self_column(d, base):
    """The entries (b, i, base + i) of a tile's (B, t, N) distances: each
    query's own column.  A view, so ``fill_`` writes it with no index
    tensors and no host value copied to the device."""
    return torch.diagonal(d, offset=base, dim1=1, dim2=2)


def _neighbour_tiles(xyz, mask, viewpoint, tile, one_tile):
    """The shared frame of both neighbourhood modes: centre, moments and
    masked squared norms, then ``one_tile(qt, qm, base, d, moments)`` per
    query tile, its (normal, curvature, ok) concatenated.  Takes (N, 3) or
    (B, N, 3); returns (normals (…, N, 3) with z = 0, curvature, valid)."""
    single = xyz.dim() == 2
    if single:
        xyz, mask = xyz[None], mask[None]
    b, n = mask.shape
    p2c, vpc = _centered(xyz, mask, viewpoint)
    moments = _moment_matrix(p2c, mask)
    t_sq_masked = torch.where(mask, (p2c * p2c).sum(dim=-1), float("inf"))
    normals, curvs, oks = [], [], []
    for base in range(0, n, tile):
        qt, qm = p2c[:, base : base + tile], mask[:, base : base + tile]
        d = _tile_dist2(qt, base, p2c, t_sq_masked)
        other_idx, count_i, sums = one_tile(qt, qm, base, d, moments)
        v, curv = _sums_to_normal(sums)
        other = torch.take_along_dim(p2c, other_idx[..., None], dim=1)
        nrm, curv, ok = _finalize_normals(qt, other, count_i, v, curv, qm, vpc)
        normals.append(nrm)
        curvs.append(curv)
        oks.append(ok)
    normal = torch.cat(normals, dim=1)
    out = (torch.cat([normal, torch.zeros((b, n, 1), dtype=torch.float32,
                                          device=xyz.device)], dim=-1),
           torch.cat(curvs, dim=1), torch.cat(oks, dim=1))
    return tuple(o[0] for o in out) if single else out


def normals_2d(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    radius: float = 2.0,
    viewpoint: tuple[float, float] = (0.0, 0.0),
    tile: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (normals (N,3) f32 with z=0, curvature (N,), valid (N,)), or
    the same with a leading B for a batch (B, N, 3) of clouds.

    Neighbour membership uses the expanded |q|² − 2q·t + |t|² distance, as
    pctpu does, with the query's own column set to exactly 0 by index and a
    strict ``d < r²`` (FLANN's radius test).  A neighbour whose true d² lies
    within ~|p−c|²·2⁻²³ of r² can classify differently from an exact test
    (D3), and from pctpu where the two products round differently."""
    # host constants stay Python scalars: a 0-d tensor made on the card is a
    # copy that waits for the device
    r2 = float(np.float32(radius * radius))

    def one_tile(qt, qm, base, d, moments):
        # STRICT <: nanoflann's RadiusResultSet::addPoint uses dist < radius
        nbr = (d < r2) & qm[..., None]
        sums = torch.bmm(nbr.to(torch.float32), moments)  # (B, tile, 6)
        # the 2-neighbour "other" point: nearest neighbour excluding self
        d_no_self = torch.where(nbr, d, float("inf"))
        _self_column(d_no_self, base).fill_(float("inf"))
        return torch.argmin(d_no_self, dim=-1), nbr.sum(dim=-1), sums

    return _neighbour_tiles(xyz, mask, viewpoint, tile, one_tile)


def normals_2d_knn(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    viewpoint: tuple[float, float] = (0.0, 0.0),
    tile: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """setKSearch mode (pctpu ``normals_2d_knn``): the neighbourhood is the k
    nearest points, self included, like nearestKSearch
    (reference/src/Normal2dEstimation.cpp:29-38, :106-190); k clamps to the
    cloud's size.  Returns what :func:`normals_2d` returns; valid is False for
    padding and for neighbourhoods of < 2 points.

    ``lax.top_k`` keeps the lower index among equal distances; the port takes
    the first k of a stable ascending sort, which does the same."""
    k = min(k, xyz.shape[-2])

    def one_tile(qt, qm, base, d, moments):
        dk, idx = torch.sort(d, dim=-1, stable=True)
        dk, idx = dk[..., :k], idx[..., :k]
        picked = torch.isfinite(dk) & qm[..., None]  # drop masked fill-ins
        b, t = idx.shape[:2]
        rows = torch.take_along_dim(moments, idx.reshape(b, t * k, 1), dim=1).reshape(b, t, k, 6)
        sums = torch.where(picked[..., None], rows, 0.0).sum(dim=2)
        # ascending order with the self column exactly 0: idx[..., 0] is self
        # and idx[..., 1] the 2-neighbour "other" point (self again for k = 1,
        # as pctpu's clamped index, where the count leaves it invalid)
        return idx[..., min(1, k - 1)], picked.sum(dim=-1), sums

    return _neighbour_tiles(xyz, mask, viewpoint, tile, one_tile)


class Normal2dEstimation:
    """The pcl_norm_2d library's interface
    (reference/include/Normal2dEstimation.h:48-130), as pctpu's facade:
    set_input_cloud / set_indices / set_radius_search / set_k_search /
    set_view_point / compute.

    Exactly one of radius or k must be set (Normal2dEstimation.cpp:117-124).
    With indices, both the queries and the searched points are the subset
    (the kd-tree is built on ``(m_in_cloud, m_indices)``, :126); entry i of
    the result belongs to ``indices[i]`` and entries past ``len(indices)`` are
    zero.  Runs on the cloud's device."""

    def __init__(self) -> None:
        self._xyz = None
        self._indices = None
        self._radius = 0.0
        self._k = 0
        self._viewpoint = (0.0, 0.0)

    def set_input_cloud(self, xyz) -> None:
        self._xyz = torch.as_tensor(xyz, dtype=torch.float32)

    def set_indices(self, indices) -> None:
        self._indices = None if indices is None else torch.as_tensor(indices,
                                                                      dtype=torch.int64)

    def set_radius_search(self, radius: float) -> None:
        self._radius = float(radius)

    def set_k_search(self, k: int) -> None:
        self._k = int(k)

    def set_view_point(self, vx: float, vy: float) -> None:
        self._viewpoint = (float(vx), float(vy))

    def compute(self):
        if self._xyz is None:
            raise RuntimeError("You have to set a cloud before ask any result !")
        if self._k == 0 and self._radius == 0.0:
            raise RuntimeError("You must call once either setRadiusSearch or setKSearch !")
        if self._k != 0 and self._radius != 0.0:
            raise RuntimeError(
                "You must call once either setRadiusSearch or setKSearch (not both) !")
        xyz = self._xyz
        n, dev = xyz.shape[0], xyz.device
        sub = xyz if self._indices is None else xyz[self._indices.to(dev)]
        m = torch.ones((sub.shape[0],), dtype=torch.bool, device=dev)
        if self._k:
            nrm, curv, ok = normals_2d_knn(sub, m, self._k, self._viewpoint)
        else:
            nrm, curv, ok = normals_2d(sub, m, self._radius, self._viewpoint)
        if self._indices is None:
            return nrm, curv, ok
        out_n = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        out_c = torch.zeros((n,), dtype=torch.float32, device=dev)
        out_ok = torch.zeros((n,), dtype=torch.bool, device=dev)
        out_n[: sub.shape[0]], out_c[: sub.shape[0]], out_ok[: sub.shape[0]] = nrm, curv, ok
        return out_n, out_c, out_ok
