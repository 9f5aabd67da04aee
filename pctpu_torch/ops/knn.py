"""Blocked brute-force 1-NN (the port of ``pctpu/ops/knn.py::nn_1``), the
CPU path of ICP, and the small-target k-NN ``knn``.

Winners are chosen on the expanded |q|² − 2q·t + |t|² score (one full-f32
matmul per query tile, as pctpu does), so a winner can differ from an
exact test inside the score-tie window ~|p|²·2⁻²³; the returned distance is
re-derived exactly from the winner's coordinates (:func:`sq_dist`).
``torch.cdist`` is not used: it picks its own expansion and precision."""

from __future__ import annotations

import torch

_INF64 = float("inf")


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``a·b + c`` (a fused multiply-add), on any
    device.  The product is exact in f64; the f64 sum can round once, and a
    second rounding to f32 goes wrong only when that sum lands exactly on an
    f32 midpoint — then the sum's exact error (TwoSum) says which way the
    true value lies, and the sum is moved one f64 ulp toward it."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    # an f32 midpoint has f64 fraction bits 28..0 equal to 1000…0
    mid = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    up = torch.nextafter(s, torch.full_like(s, _INF64))
    down = torch.nextafter(s, torch.full_like(s, -_INF64))
    s = torch.where(mid & (err > 0), up, torch.where(mid & (err < 0), down, s))
    return s.float()


def sq_dist(diff: torch.Tensor) -> torch.Tensor:
    """Squared length of (..., 3) f32 differences as
    fma(dz, dz, fma(dy, dy, dx·dx)), each step correctly rounded.

    This is the exact form XLA's CPU backend compiles pctpu's
    ``jnp.sum(diff * diff, axis=1)`` into, and the form the CUDA kernel
    computes with ``__fmaf_rn``: the kernel, its plain twin and pctpu's CPU
    path then agree bit for bit on every distance."""
    dx, dy, dz = diff[..., 0], diff[..., 1], diff[..., 2]
    return _fma_f32(dz, dz, _fma_f32(dy, dy, dx * dx))


def nn_1(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    tile: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each query point in target.

    Returns (index (Q,) int32, squared distance (Q,) f32); masked-out
    targets are +inf away, masked-out queries return +inf."""
    return nn_1_scored(query, query_mask, target, target_mask, tile)[:2]


def nn_1_scored(query, query_mask, target, target_mask, tile: int = 512):
    """:func:`nn_1` plus each winner's score (|q|² − 2q·t + |t|², the value
    the argmin ranks): (index, squared distance, score).  Winners of slices
    of the target, reduced by their scores with the lowest slice winning a
    tie, are the whole target's winners."""
    inf = torch.tensor(float("inf"), device=query.device)
    t_sq = torch.where(target_mask, (target * target).sum(dim=1), inf)
    idxs, dists, scores = [], [], []
    for s in range(0, query.shape[0], tile):
        qt = query[s : s + tile]
        qm = query_mask[s : s + tile]
        d = ((qt * qt).sum(dim=1, keepdim=True) - 2.0 * (qt @ target.T)) + t_sq[None, :]
        idx = torch.argmin(d, dim=1)
        best = sq_dist(qt - target[idx])
        idxs.append(idx.to(torch.int32))
        dists.append(torch.where(qm & target_mask[idx], best, inf))
        scores.append(d.gather(1, idx[:, None])[:, 0])
    return torch.cat(idxs), torch.cat(dists), torch.cat(scores)


# pctpu's jitted name for nn_1; torch runs eagerly, so it is the same function
nn_1_jit = nn_1


def knn(
    query: torch.Tensor,
    query_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN for small target sets (pose tables): the full (Q, T) score matrix
    and its k smallest, as pctpu's ``knn``.  Returns (indices (Q, k') int32,
    squared distances (Q, k') f32) ascending, k' = min(k, T) like pcl
    nearestKSearch.  Winners are picked on the expanded score; their
    distances are re-derived from the coordinates, +inf where the query or
    the winner is masked — as ``sum(diff * diff)`` with each product rounded,
    the form pctpu's eager (unjitted) ``knn`` computes, not :func:`sq_dist`'s
    fused one.  ``lax.top_k`` keeps the lower index among equal scores; the
    first k of a stable ascending sort do the same."""
    k = min(k, target.shape[0])
    inf = torch.tensor(float("inf"), device=query.device)
    d = ((query * query).sum(dim=1, keepdim=True) - 2.0 * (query @ target.T)) + torch.where(
        target_mask, (target * target).sum(dim=1), inf)[None, :]
    score, idx = torch.sort(d, dim=1, stable=True)
    score, idx = score[:, :k], idx[:, :k]
    diff = query[:, None, :] - target[idx]
    exact = (diff * diff).sum(dim=-1)
    found = torch.isfinite(score) & query_mask[:, None] & target_mask[idx]
    return idx.to(torch.int32), torch.where(found, exact, inf)
