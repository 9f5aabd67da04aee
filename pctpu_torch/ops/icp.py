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

One body runs P problems at once (:func:`icp_batched`, pctpu's ``icp`` under
``jax.vmap`` in the pair-batched stages): P sources, Bt targets, problem p
aligning its source to target p // (P / Bt), so the coarse stage's two yaw
guesses of a pair share the pair's target.  pctpu's ``lax.while_loop`` under
``vmap`` runs until every problem is done and freezes a done problem's
state; here the freeze is a ``torch.where`` on a (P,) ``done`` tensor, and
the host reads the count of done problems once an iteration of the whole
batch.  Every op of the body is per problem, so a problem's result does not
depend on the others (on the CPU, bit for bit, up to the reduction splits
README's D5 row names; on the card the sums over the point axis run in f64,
rounded once, and a problem's bits were observed not to hang on the batch's
size, which f64 sums in another order make likely, not certain).  :func:`icp` and its two forms are the P = 1 case;
:func:`icp_trace` runs the body a fixed ``max(max_iterations, 1)`` steps
with no host read and returns each step's state.

The NN search is the bbox-pruned CUDA kernel over Morton-sorted clouds for
CUDA tensors (one problem: ``nn_1_pruned``; a batch: ``nn_1_pruned_batched``,
one prepared target each) and the blocked brute force ``nn_1`` for CPU
tensors, one problem after another (as pctpu runs its Pallas kernel on the
TPU and the XLA path elsewhere).  ``nn_impl="sharded"`` splits each target
over a mesh's ``points`` axis (``parallel.mesh.sharded_nn_1``: ``nn_1`` on
each slice, the winners reduced over the slices), as pctpu's point-axis
scaling does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pctpu_torch.config import IcpConfig
from pctpu_torch.ops.cuda_knn import (
    gather_points,
    nn_1_pruned,
    nn_1_pruned_batched,
    prepare_target,
    prepare_targets,
    spatial_sort_payload,
)
from pctpu_torch.ops.knn import nn_1
from pctpu_torch.ops.transform import transform_xyz
from pctpu_torch.runtime import profiler

_F32_MAX = float(np.finfo(np.float32).max)

@dataclasses.dataclass(frozen=True)
class IcpResult:
    converged: torch.Tensor  # bool; (P,) for a batch
    fitness: torch.Tensor  # f32 — mean squared NN distance; (P,) for a batch
    transform: torch.Tensor  # (4, 4) f32; (P, 4, 4) for a batch

    def numpy(self) -> "IcpResult":
        """The same result as host numpy values."""
        return IcpResult(*(v.cpu().numpy() for v in
                           (self.converged, self.fitness, self.transform)))

    def select(self, index) -> "IcpResult":
        """Each field indexed by ``index`` on its leading (problem) axis."""
        return IcpResult(self.converged[index], self.fitness[index], self.transform[index])


def _point_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the point axis (dim 1) of a batch of problems.  On the card
    it runs in f64 and is rounded once to f32: torch's f32 sum over a
    non-innermost axis splits its work by the number of outputs, and
    measured on an H100 a problem summed in a batch of 8 rounded otherwise
    than in a batch of 16, which a data mesh's shards would show as other
    reports.  The f64 sum also splits by the batch, but its error is far
    below one f32 rounding, so the f32 result agreed across batch sizes
    wherever it was compared; two f64 sums that straddle an f32 rounding
    boundary would still round apart, so that is observed, not guaranteed.
    On the CPU it stays f32, pctpu's order (README D5)."""
    if x.device.type == "cuda":
        return x.double().sum(dim=1).float()
    return x.sum(dim=1)


def _point_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` whose inner dimension is the point axis, on the
    card in f64 rounded once to f32, as :func:`_point_sum` (cuBLAS picks
    its splits by shape and batch size)."""
    if a.device.type == "cuda":
        return torch.bmm(a.double(), b.double()).float()
    return torch.bmm(a, b)


def _estimate_svd(src, tgt, w):
    """Umeyama (no scale), weighted by w∈{0,1} — PCL
    TransformationEstimationSVD on the correspondence subset, per problem of
    (P, N, 3) points.  The SVD's sign convention does not matter: R = V·S·Uᵀ
    with S = diag(1, 1, sign det) is invariant to it."""
    wsum = torch.clamp_min(w.sum(dim=1), 1.0)[:, None]
    mu_s = _point_sum(src * w[..., None]) / wsum
    mu_t = _point_sum(tgt * w[..., None]) / wsum
    sd = (src - mu_s[:, None]) * w[..., None]
    td = tgt - mu_t[:, None]
    h = _point_bmm(sd.transpose(1, 2), td)  # (P, 3, 3)
    u, _, vt = torch.linalg.svd(h)
    v, ut = vt.transpose(1, 2), u.transpose(1, 2)
    d = torch.sign(torch.linalg.det(torch.bmm(v, ut)))
    one = torch.ones_like(d)
    r = torch.bmm(torch.bmm(v, torch.diag_embed(torch.stack([one, one, d], dim=-1))), ut)
    m = torch.eye(4, dtype=torch.float32, device=src.device).repeat(src.shape[0], 1, 1)
    m[:, :3, :3] = r
    m[:, :3, 3] = mu_t - torch.bmm(r, mu_s[..., None])[..., 0]
    return m


def _estimate_point_to_plane_lls(src, tgt, nrm, w):
    """PCL TransformationEstimationPointToPlaneLLS per problem: solve the
    linearised point-to-plane system (with pctpu's 1e-12 ridge), then build
    Rz(γ)Ry(β)Rx(α)."""
    a = torch.linalg.cross(src, nrm, dim=-1)  # rows: s × n
    jac = torch.cat([a, nrm], dim=-1) * w[..., None]  # (P, N, 6)
    b = (nrm * (tgt - src)).sum(dim=-1) * w
    jt = jac.transpose(1, 2)
    ata = _point_bmm(jt, jac)
    atb = _point_bmm(jt, b[..., None])[..., 0]
    eye = torch.eye(6, dtype=torch.float32, device=src.device)
    # solve_ex: a singular system yields non-finite values (as in pctpu,
    # where the < 3-correspondence gate then discards them) instead of a
    # raise, and no host sync for the error check
    x, _ = torch.linalg.solve_ex(ata + 1e-12 * eye, atb)
    alpha, beta, gamma, tx, ty, tz = x.unbind(-1)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    cg, sg = torch.cos(gamma), torch.sin(gamma)
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([
        torch.stack([cg * cb, -sg * ca + cg * sb * sa, sg * sa + cg * sb * ca, tx], dim=-1),
        torch.stack([sg * cb, cg * ca + sg * sb * sa, -cg * sa + sg * sb * ca, ty], dim=-1),
        torch.stack([-sb, cb * sa, cb * ca, tz], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ], dim=-2)


def _searches(src_mask, tgt_xyz, corr_mask, fit_mask, per, cfg, nn_impl, nn_tile, mesh):
    """(nn_corr, nn_fit): each maps transformed sources (P, N, 3) to
    (index (P, N) int64, d² (P, N)) against each problem's target, under
    the correspondence mask within the threshold, or the plain mask without
    one."""
    p = src_mask.shape[0]
    if nn_impl == "pruned":
        # the targets never move inside the loop: pack them and their boxes
        # once for each of the two masks — one launch for all of them
        if p == 1:
            def prep(m):
                return prepare_target(tgt_xyz[0], m[0])

            def search(q, prepared, md):
                idx, d2 = nn_1_pruned(q[0], src_mask[0], prepared=prepared, max_distance=md)
                return idx[None].to(torch.int64), d2[None]
        else:
            def prep(m):
                return prepare_targets(tgt_xyz, m)

            def search(q, prepared, md):
                idx, d2 = nn_1_pruned_batched(q, src_mask, prepared, md)
                return idx.to(torch.int64), d2
        corr_prep = prep(corr_mask)
        fit_prep = corr_prep if fit_mask is corr_mask else prep(fit_mask)
        return (lambda q: search(q, corr_prep, cfg.max_correspondence_distance),
                lambda q: search(q, fit_prep, None))

    if nn_impl == "sharded":
        from pctpu_torch.parallel.mesh import sharded_nn_1

        search = sharded_nn_1(mesh, tile=nn_tile)
    else:
        search = functools.partial(nn_1, tile=nn_tile)

    def brute(mask):
        def run(q):
            outs = [search(q[k], src_mask[k], tgt_xyz[k // per], mask[k // per])
                    for k in range(p)]
            return (torch.stack([o[0] for o in outs]).to(torch.int64),
                    torch.stack([o[1] for o in outs]))
        return run

    return brute(corr_mask), brute(fit_mask)


def _run(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: IcpConfig, tgt_normals,
         normal_mask, nn_tile, nn_impl, trace: bool, mesh=None):
    """The batched body (module docstring).  Returns (IcpResult of (P,)
    fields, the per-step trace or None)."""
    if nn_impl == "auto":
        nn_impl = "pruned" if src_xyz.device.type == "cuda" else "xla"
    if nn_impl not in ("pruned", "xla", "sharded"):
        raise ValueError(
            f"nn_impl must be 'auto', 'pruned', 'xla' or 'sharded', got {nn_impl!r}")
    if nn_impl == "sharded" and mesh is None:
        raise ValueError("nn_impl='sharded' needs a mesh with a 'points' axis")
    n_problems, n_targets = src_xyz.shape[0], tgt_xyz.shape[0]
    if n_targets == 0 or n_problems % n_targets:
        raise ValueError(f"icp: {n_problems} problems for {n_targets} targets")
    per = n_problems // n_targets
    dev = src_xyz.device
    max_d2 = float(np.float32(cfg.max_correspondence_distance) ** 2)
    eps_t = float(np.float32(cfg.transformation_epsilon))
    rot_thresh = float(np.float32(1.0 - cfg.transformation_epsilon))
    rel_mse = float(np.float32(cfg.euclidean_fitness_epsilon))
    if cfg.point_to_plane and tgt_normals is None:
        raise ValueError("point-to-plane ICP needs tgt_normals")

    if nn_impl == "pruned":
        # sort once: pruning needs tile locality, and a rigid transform keeps
        # it, so the source order holds across iterations (the kernels take
        # the moving source's boxes from the transformed points every pass)
        if tgt_normals is not None:
            nm = normal_mask if normal_mask is not None else torch.ones_like(tgt_mask)
            tgt_xyz, tgt_mask, tgt_normals, normal_mask = spatial_sort_payload(
                tgt_xyz, tgt_mask, tgt_normals, nm)
        else:
            tgt_xyz, tgt_mask = spatial_sort_payload(tgt_xyz, tgt_mask)
        src_xyz, src_mask = spatial_sort_payload(src_xyz, src_mask)

    corr_mask = tgt_mask
    if tgt_normals is not None and normal_mask is not None:
        corr_mask = tgt_mask & normal_mask
    nn_corr, nn_fit = _searches(src_mask, tgt_xyz, corr_mask, tgt_mask, per, cfg, nn_impl,
                                nn_tile, mesh)
    # each problem's target (and normals), for the gathers
    owner = torch.arange(n_problems, device=dev) // per
    tgt_p = tgt_xyz if per == 1 else tgt_xyz[owner]
    nrm_p = None if tgt_normals is None else (tgt_normals if per == 1 else tgt_normals[owner])

    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    final_t = guess.to(device=dev, dtype=torch.float32)
    transformed = transform_xyz(src_xyz, final_t)
    prev_mse = torch.full((n_problems,), _F32_MAX, dtype=torch.float32, device=dev)
    conv = torch.zeros((n_problems,), dtype=torch.bool, device=dev)
    done = torch.zeros_like(conv)
    it = torch.zeros((n_problems,), dtype=torch.int32, device=dev)
    steps = []
    active = n_problems
    iterations = problem_iterations = 0

    # PCL's loop is a do-while: even max_iterations=0 runs one pass
    min_one = max(cfg.max_iterations, 1)
    for step in range(min_one):
        idx, d2 = nn_corr(transformed)
        wb = src_mask & (d2 <= max_d2)
        w = wb.to(torch.float32)
        # sanitise rejected gathers BEFORE the estimation: unmatched queries
        # carry index 0, and a NaN coordinate or normal there would poison
        # the solve through NaN * 0 even though w masks the row
        keep = wb[..., None]
        tgt = torch.where(keep, gather_points(tgt_p, idx), 0.0)
        if cfg.point_to_plane:
            nrm = torch.where(keep, gather_points(nrm_p, idx), 0.0)
            inc = _estimate_point_to_plane_lls(transformed, tgt, nrm, w)
        else:
            inc = _estimate_svd(transformed, tgt, w)
        ncorr = w.sum(dim=1)
        enough = ncorr >= 3.0
        inc = torch.where(enough[:, None, None], inc, eye4)

        # convergence checks in PCL order
        cos_angle = 0.5 * (inc[:, 0, 0] + inc[:, 1, 1] + inc[:, 2, 2] - 1.0)
        trans_sqr = (inc[:, :3, 3] ** 2).sum(dim=-1)
        delta_small = (cos_angle >= rot_thresh) & (trans_sqr <= eps_t)
        # where(), not d2 * w: out-of-threshold queries carry +inf
        mse = _point_sum(torch.where(wb, d2, 0.0)) / torch.clamp_min(ncorr, 1.0)
        diff = torch.abs(mse - prev_mse)
        mse_abs_ok = diff < 1e-12
        mse_rel_ok = diff / torch.clamp_min(prev_mse, 1e-30) < rel_mse
        converged_now = delta_small | mse_abs_ok | mse_rel_ok
        hit_max = step + 1 >= cfg.max_iterations

        # a done problem keeps its state: pctpu's while_loop under vmap.
        # While the host's last read found none done, the gate is the
        # identity and is skipped (always so for one problem)
        gated = trace or active < n_problems

        def hold(old, new):
            if not gated:
                return new
            return torch.where(done.reshape(done.shape + (1,) * (new.dim() - 1)), old, new)

        final_t = hold(final_t, torch.bmm(inc, final_t))
        # PCL transforms the working cloud incrementally: per-step f32
        # rounding, not compose-then-apply
        transformed = hold(transformed, transform_xyz(transformed, inc))
        prev_mse = hold(prev_mse, mse)
        it = torch.where(done, it, step + 1)
        # < 3 correspondences → hasConverged() false (PCL aborts the loop)
        conv = hold(conv, enough & (converged_now | hit_max | conv))
        done = done | ~enough | converged_now | hit_max
        if trace:
            steps.append((final_t, prev_mse, done, conv, it))
            continue
        iterations += 1
        problem_iterations += active
        # the batch's one host read an iteration
        with profiler.span("icp.wait"):
            active = n_problems - int(done.sum())
        if not active:
            break
    if not trace:
        # batch iterations (one host read of ``done`` each), the problems
        # still active in them, and the slots the batch held for them
        profiler.count("icp.iterations", iterations)
        profiler.count("icp.problem_iterations", problem_iterations)
        profiler.count("icp.problem_slots", iterations * n_problems)

    # fitness: mean squared NN distance over all source points, against the
    # plain target mask
    _, d2 = nn_fit(transform_xyz(src_xyz, final_t))
    nsrc = src_mask.to(torch.float32).sum(dim=1)
    fitness = torch.where(
        nsrc > 0,
        _point_sum(torch.where(src_mask, d2, 0.0)) / torch.clamp_min(nsrc, 1.0),
        # getFitnessScore returns numeric_limits<double>::max() for no
        # accepted points — f32 max here (both clear the 1.5 failure gate)
        _F32_MAX,
    )
    result = IcpResult(converged=conv, fitness=fitness, transform=final_t)
    if not trace:
        return result, None
    names = ("transform", "mse", "done", "converged", "it")
    return result, {k: torch.stack([s[i] for s in steps]) for i, k in enumerate(names)}


def icp_batched(
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
    mesh=None,
) -> IcpResult:
    """P ICP alignments at once: sources ``src_xyz`` (P, N, 3) with masks
    (P, N) and guesses (P, 4, 4), targets ``tgt_xyz`` (Bt, T, 3) with masks
    (and, for point-to-plane, normals and their masks) (Bt, T), P a
    multiple of Bt; problem p aligns to target p // (P / Bt).  Returns an
    :class:`IcpResult` of (P,) fields, each problem's what :func:`icp` gives
    it alone.  Traced, the call is an ``icp.loop`` span, its host reads of
    ``done`` ``icp.wait`` spans, and it counts ``icp.iterations``,
    ``icp.problem_iterations`` and ``icp.problem_slots`` (iterations × P)."""
    with profiler.span("icp.loop"):
        return _run(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg, tgt_normals, normal_mask,
                    nn_tile, nn_impl, trace=False, mesh=mesh)[0]


def _one(x):
    return None if x is None else x[None]


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
    mesh=None,
) -> IcpResult:
    """Run one ICP alignment.  All tensors fixed-size with validity masks,
    on one device.

    For point-to-plane, ``tgt_normals`` are the target normals and
    ``normal_mask`` marks targets with defined normals (the reference's NaN
    normals are excluded from correspondences, D10).

    ``nn_impl``: "pruned" (bbox-pruned 1-NN over Morton-sorted clouds: the
    CUDA kernel on a card, its plain twin on the CPU), "xla" (pctpu's name
    for the blocked brute force ``nn_1``), "sharded" (``nn_1`` over the
    target split along ``mesh``'s 'points' axis), or "auto" (pruned for CUDA
    tensors, brute force for CPU tensors)."""
    return icp_batched(src_xyz[None], src_mask[None], tgt_xyz[None], tgt_mask[None],
                       guess[None], cfg, _one(tgt_normals), _one(normal_mask), nn_tile,
                       nn_impl, mesh).select(0)


def icp_trace(
    src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: IcpConfig,
    tgt_normals=None, normal_mask=None, nn_tile: int = 512, nn_impl: str = "auto",
):
    """pctpu's ``icp_trace``: :func:`icp` run for a fixed
    ``max(max_iterations, 1)`` steps, each gated on ``done`` (so the result
    is :func:`icp`'s), with no host read inside the loop.  Returns
    (IcpResult, trace): the trace's ``transform`` (S, 4, 4), ``mse``,
    ``done``, ``converged`` and ``it`` (S,) hold the state after each step."""
    res, steps = _run(src_xyz[None], src_mask[None], tgt_xyz[None], tgt_mask[None], guess[None],
                      cfg, _one(tgt_normals), _one(normal_mask), nn_tile, nn_impl, trace=True)
    return res.select(0), {k: v[:, 0] for k, v in steps.items()}


def icp_point_to_point(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg: IcpConfig,
                       nn_tile: int = 512, nn_impl: str = "auto", mesh=None) -> IcpResult:
    return icp(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg,
               nn_tile=nn_tile, nn_impl=nn_impl, mesh=mesh)


def icp_point_to_plane(
    src_xyz, src_mask, tgt_xyz, tgt_mask, tgt_normals, normal_mask, guess,
    cfg: IcpConfig, nn_tile: int = 512, nn_impl: str = "auto",
) -> IcpResult:
    return icp(src_xyz, src_mask, tgt_xyz, tgt_mask, guess, cfg,
               tgt_normals=tgt_normals, normal_mask=normal_mask,
               nn_tile=nn_tile, nn_impl=nn_impl)
