"""Iterative closest point with PCL-compatible estimation and convergence —
the port of ``pctpu/ops/icp.py``.

Reproduces pcl::IterativeClosestPoint / IterativeClosestPointWithNormals as
configured by the reference
(reference/BatchTopPartRegistration.cpp:192-247):

  * correspondence: 1-NN of each (already transformed) source point in the
    target, rejected when squared distance > max_correspondence_distance²;
  * estimation: point-to-point = Umeyama SVD, point-to-plane = small-angle
    LLS on (α,β,γ,tx,ty,tz) plugged into an exact Rz(γ)Ry(β)Rx(α);
  * the increment is composed onto the running transformation, which
    starts at the initial guess, and applied to the working cloud;
  * convergence in PCL's order: max iterations → converged; transform delta
    (cos θ ≥ 1−ε_t and ‖t‖² ≤ ε_t) → converged; |MSE−MSE_prev| < 1e-12 or
    relative < ε_fitness → converged; < 3 correspondences → NOT converged;
  * fitness = mean squared 1-NN distance of all transformed source points.

pctpu's ``lax.while_loop`` is a Python loop here, with early exit: each
iteration reads its ``done`` flag on the host once.  The NN search is the
bbox-pruned CUDA kernel over Morton-sorted clouds for CUDA tensors and the
blocked brute force ``nn_1`` for CPU tensors (as pctpu runs its Pallas
kernel on the TPU and the XLA path elsewhere).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pctpu_torch.config import IcpConfig
from pctpu_torch.ops.cuda_knn import nn_1_pruned, prepare_target, spatial_sort_payload
from pctpu_torch.ops.knn import nn_1
from pctpu_torch.ops.transform import transform_xyz

_F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class IcpResult:
    converged: torch.Tensor  # bool
    fitness: torch.Tensor  # f32 — mean squared NN distance
    transform: torch.Tensor  # (4, 4) f32

    def numpy(self) -> "IcpResult":
        """The same result as host numpy values."""
        return IcpResult(*(v.cpu().numpy() for v in
                           (self.converged, self.fitness, self.transform)))


def _estimate_svd(src, tgt, w):
    """Umeyama (no scale), weighted by w∈{0,1} — PCL
    TransformationEstimationSVD on the correspondence subset.  The SVD's sign
    convention does not matter: R = V·S·Uᵀ with S = diag(1, 1, sign det) is
    invariant to it."""
    wsum = torch.clamp_min(w.sum(), 1.0)
    mu_s = (src * w[:, None]).sum(dim=0) / wsum
    mu_t = (tgt * w[:, None]).sum(dim=0) / wsum
    sd = (src - mu_s) * w[:, None]
    td = tgt - mu_t
    h = sd.T @ td  # (3, 3)
    u, _, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    s = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    r = (vt.T @ s) @ u.T
    m = torch.eye(4, dtype=torch.float32, device=src.device)
    m[:3, :3] = r
    m[:3, 3] = mu_t - r @ mu_s
    return m


def _estimate_point_to_plane_lls(src, tgt, nrm, w):
    """PCL TransformationEstimationPointToPlaneLLS: solve the linearised
    point-to-plane system (with pctpu's 1e-12 ridge), then build
    Rz(γ)Ry(β)Rx(α)."""
    a = torch.linalg.cross(src, nrm)  # rows: s × n
    jac = torch.cat([a, nrm], dim=1) * w[:, None]  # (N, 6)
    b = (nrm * (tgt - src)).sum(dim=1) * w
    ata = jac.T @ jac
    atb = jac.T @ b
    eye = torch.eye(6, dtype=torch.float32, device=src.device)
    # solve_ex: a singular system yields non-finite values (as in pctpu,
    # where the < 3-correspondence gate then discards them) instead of a
    # raise, and no host sync for the error check
    x, _ = torch.linalg.solve_ex(ata + 1e-12 * eye, atb)
    alpha, beta, gamma, tx, ty, tz = x.unbind()
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([
        torch.stack([cg * cb, -sg * ca + cg * sb * sa, sg * sa + cg * sb * ca, tx]),
        torch.stack([sg * cb, cg * ca + sg * sb * sa, -cg * sa + sg * sb * ca, ty]),
        torch.stack([-sb, cb * sa, cb * ca, tz]),
        torch.stack([zero, zero, zero, one]),
    ])


def icp(
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_xyz: torch.Tensor,
    tgt_mask: torch.Tensor,
    guess: torch.Tensor,
    cfg: IcpConfig,
    tgt_normals: torch.Tensor | None = None,
    normal_mask: torch.Tensor | None = None,
    nn_tile: int = 512,
    nn_impl: str = "auto",
) -> IcpResult:
    """Run one ICP alignment.  All tensors fixed-size with validity masks,
    on one device.

    For point-to-plane, ``tgt_normals`` are the target normals and
    ``normal_mask`` marks targets with defined normals (the reference's NaN
    normals are excluded from correspondences, D10).

    ``nn_impl``: "pruned" (bbox-pruned 1-NN over Morton-sorted clouds: the
    CUDA kernel on a card, its plain twin on the CPU), "xla" (pctpu's name
    for the blocked brute force ``nn_1``), or "auto" (pruned for CUDA
    tensors, brute force for CPU tensors)."""
    if nn_impl == "auto":
        nn_impl = "pruned" if src_xyz.device.type == "cuda" else "xla"
    if nn_impl not in ("pruned", "xla"):
        raise ValueError(f"nn_impl must be 'auto', 'pruned' or 'xla', got {nn_impl!r}")
    dev = src_xyz.device
    max_d2 = float(np.float32(cfg.max_correspondence_distance) ** 2)
    eps_t = float(np.float32(cfg.transformation_epsilon))
    rot_thresh = float(np.float32(1.0 - cfg.transformation_epsilon))
    rel_mse = float(np.float32(cfg.euclidean_fitness_epsilon))

    if nn_impl == "pruned":
        # sort once: pruning needs tile locality, and a rigid transform keeps
        # it, so the source order holds across iterations (the kernels take
        # the moving source's boxes from the transformed points every pass)
        if tgt_normals is not None:
            nm = normal_mask if normal_mask is not None else torch.ones_like(tgt_mask)
            tgt_xyz, tgt_mask, tgt_normals, normal_mask = spatial_sort_payload(
                tgt_xyz, tgt_mask, tgt_normals, nm
            )
        else:
            tgt_xyz, tgt_mask = spatial_sort_payload(tgt_xyz, tgt_mask)
        src_xyz, src_mask = spatial_sort_payload(src_xyz, src_mask)

    corr_tgt_mask = tgt_mask
    if tgt_normals is not None and normal_mask is not None:
        corr_tgt_mask = tgt_mask & normal_mask

    if nn_impl == "pruned":
        # the target never moves inside the loop: pack it and its boxes once
        # for each of the two masks
        corr_prep = prepare_target(tgt_xyz, corr_tgt_mask)
        fit_prep = corr_prep if corr_tgt_mask is tgt_mask else prepare_target(tgt_xyz, tgt_mask)

        def nn_corr(q, qm, tmask):
            return nn_1_pruned(q, qm, prepared=corr_prep,
                               max_distance=cfg.max_correspondence_distance)

        def nn_fit(q, qm, tmask):
            return nn_1_pruned(q, qm, prepared=fit_prep, max_distance=None)
    else:

        def nn_corr(q, qm, tmask):
            return nn_1(q, qm, tgt_xyz, tmask, tile=nn_tile)

        nn_fit = nn_corr

    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    final_t = guess.to(device=dev, dtype=torch.float32)
    transformed = transform_xyz(src_xyz, final_t)
    prev_mse = torch.tensor(_F32_MAX, dtype=torch.float32, device=dev)
    conv = torch.tensor(False, device=dev)

    # PCL's loop is a do-while: even max_iterations=0 runs one pass
    min_one = max(cfg.max_iterations, 1)
    it = 0
    done = False
    while not done and it < min_one:
        idx, d2 = nn_corr(transformed, src_mask, corr_tgt_mask)
        idx = idx.to(torch.int64)
        wb = src_mask & (d2 <= max_d2)
        w = wb.to(torch.float32)
        # sanitise rejected gathers BEFORE the estimation: unmatched queries
        # carry index 0, and a NaN coordinate or normal there would poison
        # the solve through NaN * 0 even though w masks the row
        keep = wb[:, None]
        tgt = torch.where(keep, tgt_xyz[idx], 0.0)
        if cfg.point_to_plane:
            if tgt_normals is None:
                raise ValueError("point-to-plane ICP needs tgt_normals")
            nrm = torch.where(keep, tgt_normals[idx], 0.0)
            inc = _estimate_point_to_plane_lls(transformed, tgt, nrm, w)
        else:
            inc = _estimate_svd(transformed, tgt, w)
        ncorr = w.sum()
        enough = ncorr >= 3.0
        inc = torch.where(enough, inc, eye4)
        final_t = inc @ final_t
        # PCL transforms the working cloud incrementally: per-step f32
        # rounding, not compose-then-apply
        transformed = transform_xyz(transformed, inc)
        it += 1

        # convergence checks in PCL order
        cos_angle = 0.5 * (inc[0, 0] + inc[1, 1] + inc[2, 2] - 1.0)
        trans_sqr = (inc[:3, 3] ** 2).sum()
        delta_small = (cos_angle >= rot_thresh) & (trans_sqr <= eps_t)
        # where(), not d2 * w: out-of-threshold queries carry +inf
        mse = torch.where(wb, d2, 0.0).sum() / torch.clamp_min(ncorr, 1.0)
        diff = torch.abs(mse - prev_mse)
        mse_abs_ok = diff < 1e-12
        mse_rel_ok = diff / torch.clamp_min(prev_mse, 1e-30) < rel_mse
        converged_now = delta_small | mse_abs_ok | mse_rel_ok
        hit_max = it >= cfg.max_iterations
        # < 3 correspondences → hasConverged() false (PCL aborts the loop)
        conv = enough & (converged_now | hit_max | conv)
        prev_mse = mse
        done = bool(~enough | converged_now | hit_max)

    # fitness: mean squared NN distance over all source points, against the
    # plain target mask
    transformed = transform_xyz(src_xyz, final_t)
    _, d2 = nn_fit(transformed, src_mask, tgt_mask)
    nsrc = src_mask.to(torch.float32).sum()
    fitness = torch.where(
        nsrc > 0,
        torch.where(src_mask, d2, 0.0).sum() / torch.clamp_min(nsrc, 1.0),
        # getFitnessScore returns numeric_limits<double>::max() for no
        # accepted points — f32 max here (both clear the 1.5 failure gate)
        torch.tensor(_F32_MAX, dtype=torch.float32, device=dev),
    )
    return IcpResult(converged=conv, fitness=fitness, transform=final_t)


def icp_point_to_point(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: IcpConfig,
                       nn_tile: int = 512, nn_impl: str = "auto") -> IcpResult:
    return icp(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg,
               nn_tile=nn_tile, nn_impl=nn_impl)


def icp_point_to_plane(
    src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals, normal_mask, guess,
    cfg: IcpConfig, nn_tile: int = 512, nn_impl: str = "auto",
) -> IcpResult:
    return icp(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg,
               tgt_normals=tgt_normals, normal_mask=normal_mask,
               nn_tile=nn_tile, nn_impl=nn_impl)
