"""Plain PyTorch reference of the two registration tools for one pair
(reference/BatchTopPartRegistration.cpp:90-541 and
reference/BatchWholeRegistration.cpp:311-418, with PCL's ICP as the
reference configures it): top-part extraction, the voxel grid, 2-D
normals, point-to-plane ICP from both yaw guesses and the best of two, the
fine point-to-point ICP, and the whole-cloud ICP of the ablation.

It takes the keyframes as decoded and works everything out itself, one
pair and one problem at a time, with plain torch operations on the given
device; it imports nothing of the program.  Sums, the estimations and the
2-D scatter run in float64.  The 1-NN is a blocked brute force whose
distances are |q|² + |t|² - 2 q·t in float32 products (the form most plain
implementations take); the winner's squared distance is then taken again
exactly from its coordinates.  TF32 is off for the reference's products,
as the configuration states; the control turns it on.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32_MAX = float(np.finfo(np.float32).max)


def _f32(v: float) -> float:
    return float(np.float32(v))


def c_round(v: torch.Tensor) -> torch.Tensor:
    a = v.abs()
    k = torch.floor(a)
    r = k + (a - k >= 0.5).to(v.dtype)
    return torch.where(v < 0, -r, r)


# --- stage inputs ----------------------------------------------------------------


def top_part(xyz: torch.Tensor, label: torch.Tensor, n: int, top: dict,
             flat_cap: int) -> torch.Tensor:
    """extractTopAndFlatten (BatchTopPartRegistration.cpp:90-147): the top
    ``top_fraction`` by z (C round of the f32 product) of each grid cell
    holding ``min_grid_points`` non-ground points or more, z set to 0, in
    cell order, z descending inside a cell (ties in input order); the
    first ``flat_cap`` of them.  Returns (K, 3) f32."""
    res_x = 2.0 * top["max_radius_x"] / top["num_grid_x"]
    res_y = 2.0 * top["max_radius_y"] / top["num_grid_y"]
    x, y, z = xyz[:n, 0], xyz[:n, 1], xyz[:n, 2]
    gx = c_round((x + top["max_radius_x"]) / res_x).long()
    gy = c_round((y + top["max_radius_y"]) / res_y).long()
    ok = ((label[:n] != 0) & (gx >= 0) & (gx < top["num_grid_x"])
          & (gy >= 0) & (gy < top["num_grid_y"]))
    idx = torch.nonzero(ok).flatten().cpu().numpy()
    cell = (gx * top["num_grid_y"] + gy)[ok].cpu().numpy()
    zz = (-z[ok] + 0.0).cpu().numpy()
    order = np.lexsort((np.arange(len(idx)), zz, cell))
    cell_s = cell[order]
    kept = []
    frac = np.float32(top["top_fraction"])
    for c in np.unique(cell_s):
        run = order[cell_s == c]
        cnt = len(run)
        if cnt < top["min_grid_points"]:
            continue
        prod = np.float32(frac * np.float32(cnt))
        k = int(math.floor(prod + 0.5)) if prod >= 0 else -int(math.floor(-prod + 0.5))
        kept.append(run[:k])
    sel = idx[np.concatenate(kept)] if kept else np.zeros(0, np.int64)
    sel = torch.from_numpy(sel[:flat_cap]).to(xyz.device)
    out = torch.zeros((len(sel), 3), dtype=torch.float32, device=xyz.device)
    out[:, 0], out[:, 1] = x[sel], y[sel]
    return out


def voxel(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    """pcl::VoxelGrid: floor(coord / leaf) offset by the cloud's minimum
    (x and y extents capped at 4096 cells, z at what a 2³⁰ key budget
    leaves), one centroid a voxel in ascending key order.  (V, 3) f32."""
    inv = 1.0 / leaf
    ijk = torch.floor(xyz * inv).long()
    lo = torch.floor(xyz.amin(0) * inv).long()
    hi = torch.floor(xyz.amax(0) * inv).long()
    div = hi - lo + 1
    dx, dy = min(int(div[0]), 4096), min(int(div[1]), 4096)
    dz = min(int(div[2]), max((1 << 30) // (dx * dy), 1))
    lim = torch.tensor([dx, dy, dz], device=xyz.device)
    rel = torch.minimum(torch.clamp_min(ijk - lo, 0), lim - 1)
    key = rel[:, 0] + rel[:, 1] * dx + rel[:, 2] * dx * dy
    uniq, inverse = torch.unique(key, sorted=True, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float64, device=xyz.device)
    sums.index_add_(0, inverse, xyz.double())
    cnt = torch.bincount(inverse, minlength=len(uniq)).double()
    return (sums / cnt[:, None]).float()


def nn(query: torch.Tensor, target: torch.Tensor, block: int = 1 << 26):
    """Each query's nearest target: (index, exact squared distance f64).
    Candidates by |q|² + |t|² - 2 q·t in f32 products, both clouds shifted
    by the target's centre first; ties to the lowest index."""
    if target.shape[0] == 0:
        inf = torch.full((query.shape[0],), math.inf, dtype=torch.float64, device=query.device)
        return torch.zeros(query.shape[0], dtype=torch.long, device=query.device), inf
    c = 0.5 * (target.amin(0) + target.amax(0))
    q, t = query - c, target - c
    t2 = (t * t).sum(1)
    rows = max(1, block // max(t.shape[0], 1))
    idx = []
    for s in range(0, q.shape[0], rows):
        qs = q[s:s + rows]
        d = (qs * qs).sum(1, keepdim=True) + t2[None, :] - 2.0 * (qs @ t.T)
        idx.append(torch.argmin(d, dim=1))
    idx = torch.cat(idx)
    diff = query.double() - target[idx].double()
    return idx, (diff * diff).sum(1)


# --- 2-D normals ---------------------------------------------------------------------


def normals_2d(xyz: torch.Tensor, radius: float, block: int = 1 << 25):
    """Normal2dEstimation with a radius search (Normal2dEstimation.cpp:106-190,
    PCA2D.cpp:8-42) of a z = 0 cloud: neighbours strictly within ``radius``,
    self included; < 2 invalid; 2 the perpendicular of (self - other), a
    coincident pair invalid; else the minor eigenvector of the scatter;
    turned toward the viewpoint (0, 0).  Returns ((N, 3) f32, valid (N,))."""
    p = xyz[:, :2].double()
    n = p.shape[0]
    r2 = _f32(radius * radius)
    normals = torch.zeros((n, 2), dtype=torch.float64, device=xyz.device)
    ok = torch.zeros(n, dtype=torch.bool, device=xyz.device)
    rows = max(1, block // max(n, 1))
    for s in range(0, n, rows):
        q = p[s:s + rows]
        d = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        nbr = d < r2
        ar = torch.arange(q.shape[0], device=xyz.device)
        nbr[ar, s + ar] = True
        cnt = nbr.sum(1)
        w = nbr.double()
        sx, sy = w @ p[:, 0], w @ p[:, 1]
        mx, my = sx / cnt, sy / cnt
        dxx = w @ (p[:, 0] ** 2) - cnt * mx * mx
        dxy = w @ (p[:, 0] * p[:, 1]) - cnt * mx * my
        dyy = w @ (p[:, 1] ** 2) - cnt * my * my
        lam = 0.5 * ((dxx + dyy) - torch.sqrt(torch.clamp_min((dxx - dyy) ** 2 + 4 * dxy * dxy, 0)))
        v1 = torch.stack([dxy, lam - dxx], -1)
        v2 = torch.stack([lam - dyy, dxy], -1)
        v = torch.where((v1.abs().sum(-1) >= v2.abs().sum(-1))[:, None], v1, v2)
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        fallback = torch.tensor([1.0, 0.0], dtype=v.dtype, device=v.device)
        v = torch.where(nv > 1e-30, v / nv.clamp_min(1e-30), fallback)
        dself = torch.where(nbr, d, math.inf)
        dself[ar, s + ar] = math.inf
        other = p[torch.argmin(dself, 1)]
        seg = q - other
        segn = seg / torch.linalg.vector_norm(seg, dim=-1, keepdim=True).clamp_min(1e-300)
        pair = torch.stack([-segn[:, 1], segn[:, 0]], -1)
        nrm = torch.where((cnt == 2)[:, None], pair, v)
        good = (cnt >= 2) & ~((cnt == 2) & (other == q).all(-1))
        flip = ((-q) * nrm).sum(-1) < 0
        nrm = torch.where(flip[:, None], -nrm, nrm)
        normals[s:s + rows] = nrm
        ok[s:s + rows] = good
    out = torch.zeros((n, 3), dtype=torch.float32, device=xyz.device)
    out[:, :2] = normals.float()
    return torch.where(ok[:, None], out, 0.0), ok


# --- ICP -------------------------------------------------------------------------------


def _svd_increment(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Umeyama without scale (PCL TransformationEstimationSVD), f64."""
    ms, mt = src.mean(0), tgt.mean(0)
    h = (src - ms).T @ (tgt - mt)
    u, _, vt = torch.linalg.svd(h)
    v = vt.T
    d = torch.sign(torch.linalg.det(v @ u.T))
    r = v @ torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d])) @ u.T
    m = torch.eye(4, dtype=torch.float64, device=src.device)
    m[:3, :3] = r
    m[:3, 3] = mt - r @ ms
    return m


def _lls_increment(src: torch.Tensor, tgt: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """PCL TransformationEstimationPointToPlaneLLS, f64: the linearised
    point-to-plane system (with a 1e-12 ridge), then Rz(γ)Ry(β)Rx(α)."""
    a = torch.cat([torch.linalg.cross(src, nrm, dim=-1), nrm], -1)
    b = (nrm * (tgt - src)).sum(-1)
    x = torch.linalg.solve(a.T @ a + 1e-12 * torch.eye(6, dtype=a.dtype, device=a.device),
                           a.T @ b)
    al, be, ga, tx, ty, tz = x.tolist()
    ca, sa, cb, sb, cg, sg = (math.cos(al), math.sin(al), math.cos(be), math.sin(be),
                              math.cos(ga), math.sin(ga))
    return torch.tensor([[cg * cb, -sg * ca + cg * sb * sa, sg * sa + cg * sb * ca, tx],
                         [sg * cb, cg * ca + sg * sb * sa, -cg * sa + sg * sb * ca, ty],
                         [-sb, cb * sa, cb * ca, tz], [0, 0, 0, 1.0]],
                        dtype=torch.float64, device=src.device)


def _move(xyz: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 3) f32 points moved by a 4x4, in f32 products."""
    m = m.float()
    return xyz @ m[:3, :3].T + m[:3, 3]


def icp(src: torch.Tensor, tgt: torch.Tensor, guess: torch.Tensor, cfg: dict,
        tgt_normals: torch.Tensor | None = None, normal_ok: torch.Tensor | None = None):
    """pcl::IterativeClosestPoint(WithNormals) as configured: 1-NN
    correspondences within the distance, the estimation composed onto the
    running transform and applied to the working cloud, PCL's convergence
    order, < 3 correspondences not converged; fitness the mean squared
    1-NN distance of the moved source.  Returns (converged, fitness,
    transform (4, 4) f32)."""
    corr_tgt = tgt if normal_ok is None else tgt[normal_ok]
    corr_nrm = None if tgt_normals is None else tgt_normals[normal_ok]
    max_d2 = _f32(cfg["max_correspondence_distance"]) ** 2
    eps_t = _f32(cfg["transformation_epsilon"])
    rot_thresh = _f32(1.0 - float(cfg["transformation_epsilon"]))
    rel_mse = float(np.float32(float(cfg["euclidean_fitness_epsilon"])))
    final = guess.float().clone()
    moved = _move(src, final)
    prev = F32_MAX
    conv = False
    for step in range(max(int(cfg["max_iterations"]), 1)):
        idx, d2 = nn(moved, corr_tgt)
        w = d2 <= max_d2
        ncorr = int(w.sum())
        if ncorr < 3:
            return False, _fitness(src, tgt, final), final
        s, t = moved[w].double(), corr_tgt[idx[w]].double()
        if corr_nrm is not None:
            inc = _lls_increment(s, t, corr_nrm[idx[w]].double())
        else:
            inc = _svd_increment(s, t)
        inc = inc.float()
        cos_angle = 0.5 * (float(inc[0, 0] + inc[1, 1] + inc[2, 2]) - 1.0)
        trans_sqr = float((inc[:3, 3].double() ** 2).sum())
        delta_small = cos_angle >= rot_thresh and trans_sqr <= eps_t
        mse = float(d2[w].sum()) / ncorr
        diff = abs(mse - prev)
        converged_now = delta_small or diff < 1e-12 or diff / max(prev, 1e-30) < rel_mse
        hit_max = step + 1 >= int(cfg["max_iterations"])
        final = inc @ final
        moved = _move(moved, inc)
        prev = mse
        conv = converged_now or hit_max
        if conv:
            break
    return conv, _fitness(src, tgt, final), final


def _fitness(src, tgt, final) -> float:
    if src.shape[0] == 0:
        return F32_MAX
    _, d2 = nn(_move(src, final), tgt)
    return float(d2.mean())


# --- the tools ------------------------------------------------------------------------


def yaw_guess(angle_guess_deg: float, offset_deg: float = 0.0) -> torch.Tensor:
    """The reference's guess: the f32 angle chain
    (BatchTopPartRegistration.cpp:416-420) and a pure-yaw 4x4 in f32."""
    a = np.float32(angle_guess_deg)
    if offset_deg:
        a = np.float32(a + np.float32(offset_deg))
    rad = float(np.float32(a / np.float32(180.0))) * math.pi
    m = np.eye(4)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = math.cos(rad), -math.sin(rad), math.sin(rad), math.cos(rad)
    return torch.from_numpy(m.astype(np.float32))


def cloud(frame: dict, scale: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A decoded keyframe's (xyz f32 scaled as the window scaled it, label)."""
    xyz = np.stack([frame["x"], frame["y"], frame["z"]], axis=1) * np.float32(scale)
    return (torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(device),
            torch.from_numpy(frame["label"].astype(np.int64)).to(device))


def top_part_pair(q, m, guess_deg: float, config: dict, device) -> dict:
    """One pair of batch_top_part_registration: ``q`` and ``m`` are
    (xyz, label) of the query and match clouds.  Returns the best coarse and
    the fine (converged, fitness, transform)."""
    r = config["registration"]
    leaf = r["voxel_leaf"]
    fq = voxel(top_part(*q, q[0].shape[0], r["top_flatten"], r["flat_cap"]), leaf)
    fm = voxel(top_part(*m, m[0].shape[0], r["top_flatten"], r["flat_cap"]), leaf)
    nrm, ok = normals_2d(fm, r["normal_radius"])
    coarse = [icp(fq, fm, yaw_guess(guess_deg, off).to(device), r["coarse"], nrm, ok)
              for off in (0.0, 180.0)]
    fits = [math.inf if math.isnan(c[1]) else c[1] for c in coarse]
    best = coarse[0] if fits[0] < fits[1] else coarse[1]
    vq, vm = voxel(q[0], leaf), voxel(m[0], leaf)
    fine = icp(vq, vm, best[2], r["fine"])
    return {"coarse": best, "fine": fine}


def whole_pair(q, m, guess_deg: float, config: dict, device) -> dict:
    """One pair of batch_whole_registration: the voxel grid of both whole
    clouds and one point-to-point ICP from the yaw guess."""
    r = config["registration"]
    vq, vm = voxel(q[0], r["voxel_leaf"]), voxel(m[0], r["voxel_leaf"])
    return {"fine": icp(vq, vm, yaw_guess(guess_deg).to(device), r["whole"])}


def gaps(got: dict, want: dict) -> dict:
    """How far the program's results lie from the reference's, stage by
    stage of one pair: the translation gap (m), the rotation between the
    two (degrees) and the fitness gap relative to the reference's."""
    out = {}
    for stage in want:
        _, f_want, m_want = want[stage]
        f_got, m_got = got[stage]
        a = np.asarray(m_got, np.float64)
        b = m_want.double().cpu().numpy()
        rel = a[:3, :3].T @ b[:3, :3]
        # the angle from both the axis part and the trace: exact for small
        # angles of matrices that f32 left a little off orthonormal
        axis = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0], rel[1, 0] - rel[0, 1]])
        angle = math.atan2(0.5 * float(np.linalg.norm(axis)), 0.5 * (np.trace(rel) - 1.0))
        out[f"{stage}_t_gap_m"] = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
        out[f"{stage}_r_gap_deg"] = math.degrees(angle)
        out[f"{stage}_fitness_gap"] = abs(float(f_got) - f_want) / max(abs(f_want), 1e-6)
    return out
