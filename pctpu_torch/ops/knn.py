"""Blocked brute-force 1-NN (the port of ``pctpu/ops/knn.py::nn_1``), the
CPU path of ICP.

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
    inf = torch.tensor(float("inf"), device=query.device)
    t_sq = torch.where(target_mask, (target * target).sum(dim=1), inf)
    idxs, dists = [], []
    for s in range(0, query.shape[0], tile):
        qt = query[s : s + tile]
        qm = query_mask[s : s + tile]
        d = ((qt * qt).sum(dim=1, keepdim=True) - 2.0 * (qt @ target.T)) + t_sq[None, :]
        idx = torch.argmin(d, dim=1)
        best = sq_dist(qt - target[idx])
        idxs.append(idx.to(torch.int32))
        dists.append(torch.where(qm & target_mask[idx], best, inf))
    return torch.cat(idxs), torch.cat(dists)
